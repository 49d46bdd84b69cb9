"""What the benchmark keeps of the timed path, for the check after it.

`Capture.install()` wraps four names of the port from outside (module
attributes, looked up by the port at each call):

- integrators/path.py `_make_bounce`: the bounce each iteration of the
  regenerating drain runs.  Of a fixed set of lanes drawn from the seed it
  keeps the lane state before and after, the pixel, sample and depth; of
  every lane it counts the samples that start (depth 0, alive) and the
  samples that end in the iteration.
- integrators/path.py `_intersect` and `_occluded`: the closest-hit pass
  and the shadow predicate inside that bounce; of the same lanes it keeps
  the rays and what the traversal answered.
- integrators/render.py and integrators/regen_diff.py `_trace_regen`:
  each work item's per-sample radiance, before the film splat, and of the
  one differentiable drain the check follows (`keep_drain`) the records
  its backward pass replays.

The kept rows are index_select copies of tensors the program makes anyway
(a few small launches per iteration, no host sync).  A rename of one of
these names in the port turns the check off and the run incorrect: the
next `benchmark` change repoints it.
"""
from __future__ import annotations

import torch

STATE_KEYS = ("o", "d", "tput", "radiance", "prev_pdf", "spec", "alive",
              "medium", "rr_depth")


class Capture:
    def __init__(self, lanes: torch.Tensor, max_depth: int,
                 keep_drain=None):
        self.idx = lanes
        self.max_depth = int(max_depth)
        self.keep_drain = keep_drain    # the item whose records are kept
        self.records = []           # one dict per captured bounce
        self.items = []             # (item, out, pixel_idx, offset, waves)
        self.drains = {}            # item -> the recording forward's records
        self.item = -1
        self.counts = None          # samples started / ended (device)
        self._cur = None
        self._saved = []

    # -- install / remove ---------------------------------------------------

    def install(self):
        from pathtracing_tpu_torch.integrators import path, render
        self._patch(path, "_make_bounce", self._wrap_make_bounce)
        self._patch(path, "_intersect", self._wrap_intersect)
        self._patch(path, "_occluded", self._wrap_occluded)
        from pathtracing_tpu_torch.integrators import regen_diff
        self._patch(render, "_trace_regen", self._wrap_trace_regen)
        self._patch(regen_diff, "_trace_regen", self._wrap_trace_regen)
        return self

    def remove(self):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)
        self._saved = []

    def _patch(self, mod, name, wrapper):
        orig = getattr(mod, name)
        self._saved.append((mod, name, orig))
        setattr(mod, name, wrapper(orig))

    # -- wrappers -----------------------------------------------------------

    def _wrap_make_bounce(self, orig):
        cap = self

        def make_bounce(scene, meta, cfg, px, py, time, sample_idx, n,
                        occ_stats=None, record=False, replay=None):
            bounce = orig(scene, meta, cfg, px, py, time, sample_idx, n,
                          occ_stats, record=record, replay=replay)
            if replay is not None or not torch.is_tensor(px) \
                    or px.shape[0] <= int(cap.idx.max()):
                return bounce

            def run(state, b):
                i = cap.idx
                cap._cur = {}
                res = bounce(state, b)
                out = res[0] if record else res
                cur, cap._cur = cap._cur, None
                alive = state["alive"]
                end = alive & ~(out["alive"] & (b + 1 < cap.max_depth))
                cnt = torch.stack([(alive & (b == 0)).sum(), end.sum()])
                if cap.counts is None:
                    cap.counts = torch.zeros(2, dtype=torch.int64,
                                             device=alive.device)
                cap.counts += cnt
                rec = dict(item=cap.item, px=px[i], py=py[i],
                           sidx=sample_idx[i], b=b[i],
                           **{"in_" + k: state[k][i] for k in STATE_KEYS},
                           **{"out_" + k: out[k][i] for k in STATE_KEYS})
                rec.update({k: v.detach() for k, v in cur.items()})
                cap.records.append({k: (v.detach() if torch.is_tensor(v)
                                        else v) for k, v in rec.items()})
                return res
            return run
        return make_bounce

    def _wrap_intersect(self, orig):
        cap = self

        def intersect(scene, meta, origin, direction, t_max, time=None):
            hit = orig(scene, meta, origin, direction, t_max, time)
            if cap._cur is not None and "hit_t" not in cap._cur:
                i = cap.idx
                tm = torch.broadcast_to(torch.as_tensor(
                    t_max, device=origin.device), origin.shape[:1])
                cap._cur.update(ray_o=origin[i], ray_d=direction[i],
                                ray_tmax=tm[i], hit_t=hit["t"][i],
                                hit_kind=hit["kind"][i],
                                hit_idx=hit["idx"][i],
                                hit_valid=hit["valid"][i])
            return hit
        return intersect

    def _wrap_occluded(self, orig):
        cap = self

        def occluded(scene, meta, origin, direction, t_max, rand_key=None,
                     stats=None, time=None):
            occ = orig(scene, meta, origin, direction, t_max,
                       rand_key=rand_key, stats=stats, time=time)
            if cap._cur is not None and "occ" not in cap._cur:
                i = cap.idx
                tm = torch.broadcast_to(torch.as_tensor(
                    t_max, device=origin.device), origin.shape[:1])
                cap._cur.update(sh_o=origin[i], sh_d=direction[i],
                                sh_tmax=tm[i], occ=occ[i])
            return occ
        return occluded

    def _wrap_trace_regen(self, orig):
        cap = self

        def trace_regen(scene, cam, meta, cfg, pixel_idx, waves,
                        sample_offset, lanes=None, with_stats=False,
                        records=None):
            res = orig(scene, cam, meta, cfg, pixel_idx, waves,
                       sample_offset, lanes=lanes, with_stats=with_stats,
                       records=records)
            out = res[0] if isinstance(res, tuple) else res
            cap.items.append((cap.item, out.detach(), pixel_idx,
                              int(sample_offset), int(waves)))
            if records is not None and cap.item == cap.keep_drain:
                cap.drains[cap.item] = records
            return res
        return trace_regen

    # -- after the window ---------------------------------------------------

    def gathered(self, device="cpu"):
        """The captured bounces as one dict of tensors (rows: lane x
        iteration), on `device`."""
        if not self.records:
            return {}
        keys = [k for k in self.records[0] if k != "item"]
        keep = [r for r in self.records if all(k in r for k in keys)]
        out = {k: torch.cat([r[k].reshape(r[k].shape[0], -1)
                             if r[k].dim() > 1 else r[k] for r in keep]
                            ).to(device) for k in keys}
        n = self.idx.shape[0]
        out["item"] = torch.cat([torch.full((n,), r["item"],
                                            dtype=torch.int64)
                                 for r in keep]).to(device)
        out["lane"] = self.idx.to(device).repeat(len(keep))
        return out
