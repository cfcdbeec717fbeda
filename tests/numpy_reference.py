"""Minimal pure-NumPy re-statement of the reference pipeline (SURVEY.md §6).

This is the ATE COMPARATOR, not the product: a deliberately simple,
per-beam-loop correlative scan matcher + log-odds grid in the style of the
reference implementation (`xiaofeng419/SLAM-2D-LIDAR-SCAN`), used to sanity
check that the framework's trajectories are at least as good as what
the reference's algorithm class produces on the same logs.
"""

from __future__ import annotations

import numpy as np


class NumpyRefSLAM:
    def __init__(
        self,
        size=256,
        resolution=0.1,
        center=(10.0, 10.0),
        n_beams=180,
        max_range=12.0,
        search_xy=0.3,
        search_step=0.1,
        search_theta=0.15,
        theta_step=0.025,
        sigma_cells=1,
        l_occ=0.85,
        l_free=-0.4,
    ):
        self.res = resolution
        self.size = size
        self.ox = center[0] - size // 2 * resolution
        self.oy = center[1] - size // 2 * resolution
        self.grid = np.zeros((size, size), np.float32)
        self.angles = -np.pi / 2 + np.pi / max(n_beams - 1, 1) * np.arange(n_beams)
        self.max_range = max_range
        self.dxs = np.arange(-search_xy, search_xy + 1e-9, search_step)
        self.dths = np.arange(-search_theta, search_theta + 1e-9, theta_step)
        self.sigma = sigma_cells
        self.l_occ, self.l_free = l_occ, l_free

    def _cells(self, xs, ys):
        return (
            np.floor((ys - self.oy) / self.res).astype(int),
            np.floor((xs - self.ox) / self.res).astype(int),
        )

    def _blur(self):
        """Gaussian smear of occupied cells (reference 'search space')."""
        occ = (self.grid > 0.2).astype(np.float32)
        k = np.exp(-0.5 * (np.arange(-3, 4) / max(self.sigma, 1e-6)) ** 2)
        s = occ
        s = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 0, s)
        s = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), 1, s)
        return np.clip(s, 0.0, 1.0)

    def match(self, pose, ranges):
        S = self._blur()
        hit = (ranges > 0.1) & (ranges < self.max_range)
        best, best_pose = -1.0, pose
        for dth in self.dths:
            th = pose[2] + dth
            ex = ranges * np.cos(self.angles + th)
            ey = ranges * np.sin(self.angles + th)
            for dx in self.dxs:
                for dy in self.dxs:
                    r, c = self._cells(pose[0] + dx + ex, pose[1] + dy + ey)
                    ok = hit & (r >= 0) & (r < self.size) & (c >= 0) & (c < self.size)
                    score = S[r[ok], c[ok]].sum() / max(hit.sum(), 1)
                    if score > best:
                        best = score
                        best_pose = np.array([pose[0] + dx, pose[1] + dy, th])
        return best_pose, best

    def update(self, pose, ranges):
        r_clip = np.minimum(ranges, self.max_range)
        for k, rng in enumerate(r_clip):
            a = self.angles[k] + pose[2]
            n = max(int(rng / self.res), 1)
            ts = (np.arange(n) + 0.5) / n * max(rng - self.res, 0.0)
            rr, cc = self._cells(pose[0] + ts * np.cos(a), pose[1] + ts * np.sin(a))
            ok = (rr >= 0) & (rr < self.size) & (cc >= 0) & (cc < self.size)
            # unique cells along the ray get one l_free each
            lin = np.unique(rr[ok] * self.size + cc[ok])
            self.grid.flat[lin] += self.l_free
            if ranges[k] < self.max_range:
                er, ec = self._cells(
                    pose[0] + rng * np.cos(a), pose[1] + rng * np.sin(a)
                )
                if 0 <= er < self.size and 0 <= ec < self.size:
                    self.grid[er, ec] += self.l_occ
        np.clip(self.grid, -10, 10, out=self.grid)

    def run(self, log, bootstrap=20):
        odom = np.asarray(log["odom"], float)
        ranges = np.asarray(log["ranges"], float)
        pose = odom[0].copy()
        traj = []
        for t in range(len(odom)):
            if t > 0:
                a = odom[t - 1]
                c, s = np.cos(a[2]), np.sin(a[2])
                dw = odom[t] - a
                d = np.array(
                    [c * dw[0] + s * dw[1], -s * dw[0] + c * dw[1],
                     (dw[2] + np.pi) % (2 * np.pi) - np.pi]
                )
                c2, s2 = np.cos(pose[2]), np.sin(pose[2])
                pose = np.array(
                    [pose[0] + c2 * d[0] - s2 * d[1],
                     pose[1] + s2 * d[0] + c2 * d[1],
                     (pose[2] + d[2] + np.pi) % (2 * np.pi) - np.pi]
                )
            if t >= bootstrap:
                pose, _ = self.match(pose, ranges[t])
            self.update(pose, ranges[t])
            traj.append(pose.copy())
        return np.stack(traj)
