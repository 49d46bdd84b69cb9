"""The reference's own traversal: a brute-force scan over chunk boxes.

Triangles are ordered by the Morton code of their centroids and cut into
chunks of CHUNK; a ray tests every triangle of every chunk whose box it
enters, so the result is the brute-force scan's (a box test only skips
triangles the ray cannot hit).  Spheres and quads are few and tested
against every ray.  Plain PyTorch, float32 (or the dtype asked for: the
lower-precision control).  Nothing here comes from the program.
"""
from __future__ import annotations

import torch

CHUNK = 1024
SHADOW_EPS = 1e-5
BIG = 3.0e38


def inv_dir(d):
    """1 / d, a zero component taken as 1e-30."""
    return 1.0 / torch.where(d.abs() < 1e-30, torch.full_like(d, 1e-30), d)


def entered(lo, hi, o, inv, t_max):
    """[R, B]: ray r (origin o, inverse direction inv) enters box b within
    t_max, every test with a relative slack: a box test only skips what
    the ray cannot hit."""
    t0 = (lo[None] - o[:, None]) * inv[:, None]
    t1 = (hi[None] - o[:, None]) * inv[:, None]
    tn = torch.minimum(t0, t1).amax(-1)
    tf = torch.maximum(t0, t1).amin(-1)
    return (tn <= tf * (1 + 1e-5) + 1e-5) & (tf >= 0) \
        & (tn <= t_max[:, None] * (1 + 1e-5) + 1e-5)


def _morton(c, lo, hi):
    q = ((c - lo) / torch.clamp(hi - lo, min=1e-20) * 1023.0).clamp(0, 1023)
    q = q.to(torch.int64)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    return spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)


class Scan:
    """tri_v [T,3,3]; sph_c [S,3], sph_r [S]; quads as the scene tables
    hold them (q, u, v and the plane's n / d / w).  n_tri, n_sph, n_quad
    give the live rows (the tables are padded to one row).  inst: the
    scan of the run-time instances (iscan.InstScan), None without."""

    def __init__(self, scene, n_tri, n_sph, n_quad, dtype=torch.float32,
                 inst=None):
        self.dtype = dtype
        self.inst = inst
        tv = scene["tri_v"][:n_tri].to(dtype)
        cen = tv.float().mean(1)
        lo, hi = cen.min(0).values, cen.max(0).values
        order = torch.argsort(_morton(cen, lo, hi))
        pad = (-n_tri) % CHUNK
        order = torch.cat([order, order[-1:].expand(pad)])
        self.order = order.view(-1, CHUNK)                   # [C, CHUNK]
        self.tv = tv[order].view(-1, CHUNK, 3, 3)
        flat = self.tv.float().view(self.tv.shape[0], -1, 3)
        self.box_lo = flat.min(1).values
        self.box_hi = flat.max(1).values
        self.sph = (scene["sph_c"][:n_sph].to(dtype),
                    scene["sph_r"][:n_sph].to(dtype))
        self.quad = {k: scene[k][:n_quad].to(dtype)
                     for k in ("quad_q", "quad_u", "quad_v", "quad_n",
                               "quad_d", "quad_w")}

    # -- per-shape tests (ray i against prim i) ----------------------------

    @staticmethod
    def tri_hit(o, d, tv, t_min=SHADOW_EPS):
        """Two-sided Moller-Trumbore of rays [..., 3] against triangles
        [..., 3, 3] (broadcast).  Returns (t, valid, u, v)."""
        v0, v1, v2 = tv[..., 0, :], tv[..., 1, :], tv[..., 2, :]
        e1, e2 = v1 - v0, v2 - v0
        h = torch.cross(d.expand_as(e2), e2, dim=-1)
        det = (e1 * h).sum(-1)
        small = det.abs() < 1e-9
        inv = 1.0 / torch.where(small, torch.ones_like(det), det)
        s = o - v0
        u = (s * h).sum(-1) * inv
        q = torch.cross(s, e1.expand_as(s), dim=-1)
        v = (d * q).sum(-1) * inv
        t = (e2 * q).sum(-1) * inv
        ok = ~small & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) \
            & (t >= t_min)
        return t, ok, u, v

    @staticmethod
    def sph_hit(o, d, c, r, t_min=SHADOW_EPS):
        oc = o - c
        a = (d * d).sum(-1)
        b = (oc * d).sum(-1)
        cc = (oc * oc).sum(-1) - r * r
        disc = b * b - a * cc
        ok = disc > 0
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t0, t1 = (-b - sq) / a, (-b + sq) / a
        v0, v1 = ok & (t0 > t_min), ok & (t1 > t_min)
        t = torch.where(v0, t0, torch.where(v1, t1, torch.full_like(t0, BIG)))
        return t, v0 | v1

    @staticmethod
    def quad_hit(o, d, q, u, v, n, t_min=SHADOW_EPS):
        dn = (d * n).sum(-1)
        small = dn.abs() < 1e-8
        t = ((q - o) * n).sum(-1) / torch.where(small, torch.ones_like(dn),
                                                 dn)
        p = o + t[..., None] * d - q
        uu, vv, uv = (u * u).sum(-1), (v * v).sum(-1), (u * v).sum(-1)
        pu, pv = (p * u).sum(-1), (p * v).sum(-1)
        det = uu * vv - uv * uv
        a = (vv * pu - uv * pv) / det
        b = (uu * pv - uv * pu) / det
        ok = ~small & (t >= t_min) & (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
        return t, ok

    # -- whole-scene queries -----------------------------------------------

    def tri_hits(self, o, d, t_max, rays_per_batch=256, pairs_per_batch=1024):
        """Every triangle hit with t in [SHADOW_EPS, t_max]: (ray, tri, t,
        u, v) as flat tensors."""
        o, d = o.to(self.dtype), d.to(self.dtype)
        t_max = t_max.to(self.dtype)
        out = [[], [], [], [], []]
        inv = inv_dir(d)
        for r0 in range(0, o.shape[0], rays_per_batch):
            ob, ib = o[r0:r0 + rays_per_batch].float(), \
                inv[r0:r0 + rays_per_batch].float()
            tm = t_max[r0:r0 + rays_per_batch].float()
            hit = entered(self.box_lo, self.box_hi, ob, ib, tm)
            ri, ci = torch.nonzero(hit, as_tuple=True)
            for p0 in range(0, ri.shape[0], pairs_per_batch):
                rr = ri[p0:p0 + pairs_per_batch] + r0
                cc = ci[p0:p0 + pairs_per_batch]
                t, ok, u, v = self.tri_hit(o[rr][:, None], d[rr][:, None],
                                           self.tv[cc])
                ok = ok & (t <= t_max[rr][:, None])
                pi, ji = torch.nonzero(ok, as_tuple=True)
                out[0].append(rr[pi])
                out[1].append(self.order[cc[pi], ji])
                out[2].append(t[pi, ji].float())
                out[3].append(u[pi, ji].float())
                out[4].append(v[pi, ji].float())
        dev = o.device
        if not out[0]:
            z = torch.zeros(0, dtype=torch.int64, device=dev)
            f = torch.zeros(0, dtype=torch.float32, device=dev)
            return z, z, f, f, f
        return tuple(torch.cat(x) for x in out)

    def analytic_hits(self, o, d, t_max):
        """[N, S] and [N, Q] (t, valid) of every sphere and quad."""
        o, d = o.to(self.dtype)[:, None], d.to(self.dtype)[:, None]
        c, r = self.sph
        ts, vs = self.sph_hit(o, d, c[None], r[None])
        q = self.quad
        tq, vq = self.quad_hit(o, d, q["quad_q"][None], q["quad_u"][None],
                               q["quad_v"][None], q["quad_n"][None])
        tm = t_max.to(self.dtype)[:, None]
        return (ts.float(), vs & (ts <= tm)), (tq.float(), vq & (tq <= tm))
