"""What decides ``correct``: the program's outputs against the reference.

A step is checked from the program's state before it (the start: the
benchmark's own scene) and the program's state after it, both whole:

- ``rows_off``: output rows whose position or mass is not, bit for bit,
  the reference's: the Morton order of the input and the float32 drift
  (the sort and the integrator's first half);
- ``kick_off``: output rows whose velocity is not, bit for bit, the
  reference's half-kick with the row's own output ``acc`` (the closing
  half-kick);
- ``force_err``: the accuracy of the output ``acc`` on receivers drawn
  from the seed against float64 all-pairs (the sort, the build and the
  θ-walk through the forces), held to the configuration's stated bound.

A viewer tick's frame is decoded from the program's PNG and compared
pixel for pixel (``px_off``) with the reference frame of the state it
draws, under the camera the tick's keys give.

``control=True`` puts the reference, computed in bfloat16 (the precision
below the configurations' float32), in the program's place: its numbers
are the control's readings. Only the outputs of the control differ; the
reference it is held to is the same.
"""

from __future__ import annotations

import numpy as np
import torch

from nbody_bench.reference import octree, order, render, step

#: the precision of the control, below the configurations' float32
CONTROL_DTYPE = torch.bfloat16
FIELDS = ("pos", "vel", "acc", "mass")


def sample_rows(seed: int, n: int, k: int, salt: int = 0) -> torch.Tensor:
    """(min(k, n),) sorted int64 rows drawn from the seed, without
    replacement."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])
    return torch.from_numpy(np.sort(rng.choice(n, size=min(k, n), replace=False)))


def _sorted_input(pre: dict, config: dict, dtype):
    """(keys or None, the input rows in the order the step emits them)."""
    tp = config.get("tree_params", {})
    if not config["guarantees"].get("morton_reorder_every_step", False):
        return None, pre
    pos = pre["pos"].to(dtype)
    perm, bound, keys = order.morton_order(pos, tp["max_depth"])
    return (keys, bound), {k: v[perm] for k, v in pre.items()}


def check_step(pre: dict, out: dict, config: dict, seed: int, receivers: int,
               control: bool = False, count: bool = False) -> dict:
    """The numbers of one step: ``pre`` and ``out`` are the whole state
    before and after it in the program's row order (dicts of
    pos/vel/acc/mass tensors on the device the reference runs on)."""
    sp = config["sim_params"]
    g, e, dt = sp["g"], sp["e"], sp["dt"]
    n = pre["pos"].shape[0]
    key_bound, s = _sorted_input(pre, config, torch.float32)
    vel_h, pos_new = step.drift(s["pos"], s["vel"], s["acc"], dt)
    idx = sample_rows(seed, n, receivers).to(pre["pos"].device)
    want = step.allpairs(pos_new[idx], idx, s["pos"], s["mass"], g, e, dt)
    if control:
        _, sc = _sorted_input(pre, config, CONTROL_DTYPE)
        vh_c, pos_c = step.drift(sc["pos"], sc["vel"], sc["acc"], dt, CONTROL_DTYPE)
        acc_c = step.allpairs(pos_c[idx], idx, sc["pos"], sc["mass"], g, e, dt, CONTROL_DTYPE)
        out = {"pos": pos_c.float(), "mass": sc["mass"].float()}
        got_acc = acc_c.float()
        kick_off = int((step.kick(vh_c[idx], acc_c, dt).float()
                        != step.kick(vel_h[idx], got_acc, dt)).any(1).sum())
    else:
        got_acc = out["acc"][idx]
        kick_off = int((out["vel"] != step.kick(vel_h, out["acc"], dt)).any(1).sum())
    rows_off = int(((out["pos"] != pos_new).any(1) | (out["mass"] != s["mass"])).sum())
    nums = {"rows_off": rows_off, "kick_off": kick_off, "force_err": step.force_err(got_acc, want)}
    if count and key_bound is not None:
        tp = config["tree_params"]
        keys, bound = key_bound
        levels = octree.build(keys, s["pos"], s["mass"], bound, tp["max_depth"], tp["leaf_bucket"])
        nums["nodes"] = octree.node_count(levels)
        nums["interactions_mean"] = float(
            octree.interactions(levels, pos_new[idx], tp["theta"]).double().mean())
    return nums


KEYMAP = {"w": "forward", "s": "backward", "a": "left", "d": "right", "q": "up", "e": "down"}


def camera_after(keys: list[str], viewer: dict) -> render.Camera:
    """The reference camera after one controller tick for each held key of
    each tick in ``keys``."""
    cam = render.Camera(aspect=viewer["width"] / viewer["height"])
    for held in keys:
        for k in held.split(",") if held else []:
            if k in KEYMAP:
                cam = cam.moved(KEYMAP[k], viewer["speed"])
    return cam


def check_frame(pos: torch.Tensor, png: bytes, keys: list[str], viewer: dict,
                control: bool = False) -> int:
    """Pixels of the program's frame that differ from the reference frame
    of ``pos`` under the camera of ``keys``."""
    cam = camera_after(keys, viewer)
    want = render.frame_u8(pos.float().cpu().numpy(), cam, viewer["width"], viewer["height"],
                           viewer["alpha"], viewer["footprint"])
    if control:
        got = render.frame_u8(pos.to(CONTROL_DTYPE).float().cpu().numpy(), cam, viewer["width"],
                              viewer["height"], viewer["alpha"], viewer["footprint"])
    else:
        got = render.decode_png(png)
    if got.shape != want.shape:
        return int(want.size)
    return int((got != want).sum())


class Checks:
    """The numbers compared, each with its limit (a number passes at or
    below its limit)."""

    def __init__(self):
        self.items: dict[str, tuple[float, float]] = {}

    def add(self, name: str, value, limit) -> None:
        self.items[name] = (value, limit)

    def add_step(self, prefix: str, nums: dict, config: dict) -> None:
        self.add(f"{prefix}.rows_off", nums["rows_off"], 0)
        self.add(f"{prefix}.kick_off", nums["kick_off"], 0)
        self.add(f"{prefix}.force_err", nums["force_err"], config["guarantees"]["force_err_max"])

    @property
    def correct(self) -> bool:
        return bool(self.items) and all(v == v and v <= lim for v, lim in self.items.values())

    def failed(self) -> list[str]:
        return [k for k, (v, lim) in self.items.items() if not (v == v and v <= lim)]

    def as_json(self) -> dict:
        return {k: {"value": v, "limit": lim} for k, (v, lim) in self.items.items()}

    def lines(self) -> list[str]:
        return [f"check {k} = {v!r} (limit {lim!r})" for k, (v, lim) in self.items.items()]
