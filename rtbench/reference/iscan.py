"""The reference's traversal of run-time instances: instance boxes over
per-model chunk boxes (a top level over bottom levels).

It reads only the reference's own build of the description: each model's
object-space triangles once (otri_v; an instance's model is its range
inst_base / inst_count) and each instance's affine maps (inst_fwd
object-to-world, inst_inv world-to-object).

- Per model, the triangles are ordered by the Morton code of their
  centroids and cut into chunks of ICHUNK with boxes, as scan.py does for
  the world triangles.
- Per instance, a world box: the eight corners of its model's box pushed
  through inst_fwd in float64, widened by a relative margin.
- Per ray, every instance box is tested.  For each instance the ray
  enters, the ray goes to object space by inst_inv, its direction left
  unnormalised so that t stays the world t, and meets that model's chunk
  boxes and then the triangles of the chunks it enters.

So the triangle tests follow the instances a ray enters, not the
instanced triangle total (`tri_tests` counts them).  A hit is (ray,
instance, object triangle, t, u, v); in the scene's encoding it is kind
SHAPE_ITRI, idx = instance * n_obj_tri + object triangle.  Plain PyTorch,
float32, or the dtype asked for (the lower-precision control: the object
triangles, the inverse maps and the rays rounded to it).  Nothing here
comes from the program.
"""
from __future__ import annotations

import torch

from .scan import Scan, _morton, entered, inv_dir

ICHUNK = 64
# relative widening of the instance boxes
WIDEN = 1e-5
# slab tests of one batch (rays x boxes)
BUDGET = 1 << 22


class InstScan:
    """scene: the reference's tables with otri_v, inst_fwd, inst_inv,
    inst_base and inst_count."""

    def __init__(self, scene, dtype=torch.float32):
        self.dtype = dtype
        ov = scene["otri_v"]
        dev = ov.device
        self.n_obj_tri = ov.shape[0]
        self.otri_v = ov.to(dtype)
        self.n_inst = scene["inst_fwd"].shape[0]
        self.base = scene["inst_base"].long()
        self.count = scene["inst_count"].long()
        key = torch.stack([self.base, self.count], 1)
        models, self.inst_model = torch.unique(key, dim=0,
                                               return_inverse=True)
        # the world-to-object maps as the scan uses them (rounded to dtype)
        self.inv = scene["inst_inv"].to(dtype).float()
        tvs, orders, live, first, n_chunks, mlo, mhi = ([] for _ in range(7))
        c0 = 0
        for base, count in models.tolist():
            tv = ov[base:base + count].to(dtype)
            pts = tv.double().reshape(-1, 3)
            mlo.append(pts.min(0).values)
            mhi.append(pts.max(0).values)
            cen = tv.float().mean(1)
            order = torch.argsort(_morton(cen, cen.min(0).values,
                                          cen.max(0).values))
            pad = (-count) % ICHUNK
            live.append(torch.arange(count + pad, device=dev) < count)
            order = torch.cat([order, order[-1:].expand(pad)])
            tvs.append(tv[order].view(-1, ICHUNK, 3, 3))
            orders.append(order.view(-1, ICHUNK) + base)
            first.append(c0)
            n_chunks.append(tvs[-1].shape[0])
            c0 += n_chunks[-1]
        self.tv = torch.cat(tvs)                     # [C, ICHUNK, 3, 3]
        self.order = torch.cat(orders)               # [C, ICHUNK] otri ids
        # hits on the padding's copies of a model's last triangle are dropped
        self.live = torch.cat(live).view(-1, ICHUNK)
        flat = self.tv.float().view(c0, -1, 3)
        self.chunk_lo, self.chunk_hi = flat.min(1).values, flat.max(1).values
        self.model_first = first
        self.model_chunks = n_chunks
        # each instance's world box: its model box's corners through fwd
        lo, hi = torch.stack(mlo), torch.stack(mhi)           # [M, 3]
        sel = torch.tensor([[0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
                            [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]],
                           device=dev, dtype=torch.bool)
        corners = torch.where(sel[None], hi[:, None], lo[:, None])  # [M,8,3]
        fwd = scene["inst_fwd"].double()
        wc = corners[self.inst_model] @ fwd[:, :, :3].transpose(1, 2) \
            + fwd[:, None, :, 3]
        wlo, whi = wc.min(1).values, wc.max(1).values
        pad = WIDEN * (whi - wlo + torch.maximum(wlo.abs(), whi.abs()))
        self.box_lo, self.box_hi = (wlo - pad).float(), (whi + pad).float()
        self.tri_tests = 0

    def _rays(self, *xs):
        """Ray tensors as the scan holds them: rounded to dtype, in
        float32."""
        return tuple(x.to(self.dtype).float() for x in xs)

    def pairs(self, o, d, t_max):
        """(ray, instance) of every instance box a ray enters within
        t_max."""
        o, d, t_max = self._rays(o, d, t_max)
        step = max(1, BUDGET // max(self.n_inst, 1))
        rays, insts = [], []
        for r0 in range(0, o.shape[0], step):
            hit = entered(self.box_lo, self.box_hi, o[r0:r0 + step],
                          inv_dir(d[r0:r0 + step]), t_max[r0:r0 + step])
            r, i = torch.nonzero(hit, as_tuple=True)
            rays.append(r + r0)
            insts.append(i)
        if not rays:
            z = torch.zeros(0, dtype=torch.int64, device=o.device)
            return z, z
        return torch.cat(rays), torch.cat(insts)

    def entered_any(self, o, d, t_max):
        """Bool per ray: it enters some instance's box within t_max."""
        out = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
        out[self.pairs(o, d, t_max)[0]] = True
        return out

    def to_object(self, o, d, inst):
        """Rays in the object space of instances `inst` (direction
        unnormalised: t is the world t)."""
        a = self.inv[inst]
        lin = a[:, :, :3]
        oo = (lin @ o[:, :, None])[..., 0] + a[:, :, 3]
        dd = (lin @ d[:, :, None])[..., 0]
        return oo, dd

    def hits(self, o, d, t_max, pairs_per_batch=1024):
        """Every instanced triangle hit with t in [SHADOW_EPS, t_max]:
        (ray, instance, object triangle, t, u, v) as flat tensors."""
        ray, inst = self.pairs(o, d, t_max)
        o, d, t_max = self._rays(o, d, t_max)
        oo, dd = self.to_object(o[ray], d[ray], inst)
        tm = t_max[ray]
        model = self.inst_model[inst]
        out = [[], [], [], [], [], []]
        for m in torch.unique(model).tolist():
            f, n = self.model_first[m], self.model_chunks[m]
            lo, hi = self.chunk_lo[f:f + n], self.chunk_hi[f:f + n]
            sel = torch.nonzero(model == m)[:, 0]
            step = max(1, BUDGET // n)
            for s0 in range(0, sel.shape[0], step):
                s = sel[s0:s0 + step]
                p, c = torch.nonzero(entered(lo, hi, oo[s], inv_dir(dd[s]),
                                             tm[s]), as_tuple=True)
                p, c = s[p], c + f
                for q0 in range(0, p.shape[0], pairs_per_batch):
                    pp, cc = p[q0:q0 + pairs_per_batch], \
                        c[q0:q0 + pairs_per_batch]
                    self.tri_tests += pp.shape[0] * ICHUNK
                    t, ok, u, v = Scan.tri_hit(
                        oo[pp].to(self.dtype)[:, None],
                        dd[pp].to(self.dtype)[:, None], self.tv[cc])
                    ok = ok & self.live[cc] & (t.float() <= tm[pp][:, None])
                    pi, ji = torch.nonzero(ok, as_tuple=True)
                    out[0].append(ray[pp[pi]])
                    out[1].append(inst[pp[pi]])
                    out[2].append(self.order[cc[pi], ji])
                    out[3].append(t[pi, ji].float())
                    out[4].append(u[pi, ji].float())
                    out[5].append(v[pi, ji].float())
        if not out[0]:
            z = torch.zeros(0, dtype=torch.int64, device=o.device)
            f = torch.zeros(0, dtype=torch.float32, device=o.device)
            return z, z, z, f, f, f
        return tuple(torch.cat(x) for x in out)

    def named_hit(self, o, d, idx):
        """(t, valid) of ray i against the instanced triangle idx[i]
        (instance * n_obj_tri + object triangle); an id outside the table,
        or of a triangle outside the instance's model, is no hit."""
        inside = (idx >= 0) & (idx < self.n_inst * self.n_obj_tri)
        idx = torch.where(inside, idx, 0)
        inst, otri = idx // self.n_obj_tri, idx % self.n_obj_tri
        first = self.base[inst]
        inside = inside & (otri >= first) & (otri < first + self.count[inst])
        o, d = self._rays(o, d)
        oo, dd = self.to_object(o, d, inst)
        t, ok, _, _ = Scan.tri_hit(oo.to(self.dtype), dd.to(self.dtype),
                                   self.otri_v[otri])
        return t.float(), ok & inside
