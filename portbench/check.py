"""The comparison that decides ``correct``.

Before the window the harness draws from the seed a sample of pixels,
stratified over ``row_groups`` groups of rows (so every band of a sharded
frame is in it), and keeps those pixels of every image the window brings
to the host and of the accumulated radiance behind it (each rank those of
its own band).  After the window it draws from the seed which jobs to
check, and the plain reference (``portbench.reference.render``) renders
the same pixels over the same frames (RNG epochs) through the same camera.
Three numbers are compared, each against its limit in
``portbench/checks/<workload>.json``:

- ``image_mean_abs``: the mean over the checked jobs, pixels and channels
  of |program - reference| of the resolved display values in [0, 1], a
  value that is not a number counting as 1 off;
- ``pixels_off_share``: the share of the checked pixels whose largest
  channel gap exceeds ``off_threshold``;
- ``radiance_rel_gap``: sum |program - reference| / sum |reference| of the
  mean radiance (the sums over the sample count) of the same pixels, so a
  gap in bright pixels, which the tone map compresses, counts at its full
  size; a value that is not a number counts as |reference| + 1 off.

Both sides follow the same RNG stream a path, so a sound run differs from
the reference only where float32 rounding sends a path another way.
"""

from __future__ import annotations

import numpy as np

CHECK_SALT = 0x5EED_C4EC


def sample_pixels(seed: int, width: int, height: int, n: int,
                  groups: int) -> np.ndarray:
    """`n` distinct pixel indices, n / groups from each of `groups` equal
    groups of rows, drawn from the seed; sorted."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, CHECK_SALT])
    rows = height // groups
    per = n // groups
    out = []
    for g in range(groups):
        start = g * rows * width
        span = (rows if g < groups - 1 else height - g * rows) * width
        out.append(start + rng.choice(span, size=per, replace=False))
    return np.sort(np.concatenate(out)).astype(np.int64)


def choose_jobs(seed: int, n_jobs: int, k: int) -> list:
    """`k` of the window's `n_jobs` jobs (all when fewer), drawn from the
    seed."""
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32,
                                 CHECK_SALT + 1])
    if n_jobs <= k:
        return list(range(n_jobs))
    return sorted(int(j) for j in rng.choice(n_jobs, size=k, replace=False))


def numbers(got: np.ndarray, want: np.ndarray, off_threshold: float,
            got_rad: np.ndarray, want_rad: np.ndarray) -> dict:
    """The compared numbers of (jobs, pixels, 3) display values and mean
    radiance."""
    gap = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    # display values lie in [0, 1]: one that is not a number is 1 off
    gap = np.where(np.isfinite(gap), gap, 1.0)
    ref = np.asarray(want_rad, np.float64)
    rgap = np.abs(np.asarray(got_rad, np.float64) - ref)
    rgap = np.where(np.isfinite(rgap), rgap, np.abs(ref) + 1.0)
    return {"image_mean_abs": float(gap.mean()),
            "pixels_off_share": float((gap.max(-1) > off_threshold).mean()),
            "radiance_rel_gap": float(rgap.sum()
                                      / max(np.abs(ref).sum(), 1e-30))}


def judge(nums: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}): correct when every number is
    at or below its limit and finite."""
    table = {k: {"value": nums[k], "limit": limits[k]} for k in limits}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
