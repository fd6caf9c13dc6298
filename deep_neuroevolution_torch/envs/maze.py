"""Hard Maze as batched tensor ops.

The counterpart of the JAX package's envs/maze.py (after the reference's
C++ NEAT hard maze, gym_tensorflow/maze/maze.h:299-816 and
tf_maze.cpp:40-104), with its formulas copied term for term:

* 6 rangefinders at [-90, -45, 0, 45, 90, -180]° from the heading, range
  100, the nearest wall intersection (maze.h:345-358, 736-773); 4 radar
  quadrants that fire when the goal direction, in the heading's frame and
  by the reference's atan-based ``angle()`` (maze.h:144-160), falls inside;
* observation [1, rangefinders/100 ×6, radar ×4] (maze.h:553-577);
* actions offset by +0.5 and clipped to [0, 1] (tf_maze.cpp:80); velocity
  mode with steps of at most ±0.2 and speeds of at most ±3; the position
  moves by the old heading, then the heading turns and wraps by > 360 and
  < 0 (maze.h:604-692); a move is undone when a wall lies within radius 8
  (maze.h:694-702);
* done at the env's own step 400; the reward is 0 but on that step, where
  it is −distance(hero, goal) (tf_maze.cpp:78-94); the BC is (x, y).

Everything is float32, as in the JAX package (x64 off): the geometry and
every constant are float32 tensors or Python scalars, which PyTorch casts
to the tensor's float32. The port keeps its own copy of ``HARD_MAZE_TXT``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .core import Continuous, Env, register

_DEG2RAD = math.pi / 180.0  # maze.h uses 3.1415926; float32 rounds both alike

# the reference's maze/hard_maze.txt (format: maze.h:468-495)
HARD_MAZE_TXT = """0
400
13
36 184
0
31 20
31 20
41 5 3 8
3 8 4 49
4 49 57 53
4 49 7 202
7 202 195 198
195 198 186 8
186 8 39 5
56 54 56 157
57 106 158 162
77 201 108 164
6 80 33 121
192 146 87 91
56 55 133 30
"""

RANGEFINDER_ANGLES = (-90.0, -45.0, 0.0, 45.0, 90.0, -180.0)  # maze.h:352-358
RADAR_ANGLES = ((315.0, 405.0), (45.0, 135.0), (135.0, 225.0), (225.0, 315.0))  # maze.h:361-372
RANGEFINDER_RANGE = 100.0  # maze.h:343
HERO_RADIUS = 8.0  # maze.h:342
EPISODE_STEPS = 400  # tf_maze.cpp:91-94


class MazeState(NamedTuple):
    x: torch.Tensor  # [B] f32
    y: torch.Tensor
    heading: torch.Tensor  # degrees, [0, 360]
    speed: torch.Tensor
    ang_vel: torch.Tensor
    t: torch.Tensor  # [B] int32 step count


def parse_maze(text: str) -> dict:
    """maze.h:468-495: disable, steps, num_lines, start, heading, end, poi,
    then the wall segments (ax ay bx by) as float32 ``[L, 4]``."""
    it = iter(text.split())
    nxt = lambda: next(it)  # noqa: E731
    disable = int(nxt())
    steps = int(nxt())
    num_lines = int(nxt())
    start = (float(nxt()), float(nxt()))
    heading = float(nxt())
    end = (float(nxt()), float(nxt()))
    poi = (float(nxt()), float(nxt()))
    segs = np.array([[float(nxt()) for _ in range(4)] for _ in range(num_lines)], np.float32)
    return dict(disable=disable, steps=steps, start=start, heading=heading, end=end, poi=poi, segs=segs)


def _point_angle(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """maze.h:144-160 ``Point::angle``: atan(y/x) in degrees for x > 0 (so
    possibly negative), +180 for x < 0, and 90 or 270 on x == 0; not atan2,
    which differs on the axes."""
    ang = torch.atan(y / torch.where(x == 0.0, torch.ones_like(x), x)) / math.pi * 180.0
    ang = torch.where(x > 0.0, ang, ang + 180.0)
    return torch.where(x == 0.0, torch.where(y > 0.0, 90.0, 270.0).to(ang.dtype), ang)


class MazeEnv(Env):
    """Batched Hard Maze; ``make('maze')`` or direct."""

    obs_shape = (11,)
    action_space = Continuous(2)
    default_timestep_cutoff = EPISODE_STEPS  # tf_maze.py:34-36
    bc_dim = 2

    def __init__(self, maze_text: str = HARD_MAZE_TXT):
        self.cfg = parse_maze(maze_text)
        self._consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}

    def geometry(self, device: torch.device) -> Tuple[torch.Tensor, ...]:
        """(segs [L, 4], rangefinder angles [6], radar lower and upper
        bounds [4]), float32 on ``device``."""
        device = torch.device(device)
        if device not in self._consts:
            f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)  # noqa: E731
            self._consts[device] = (
                torch.from_numpy(self.cfg["segs"]).to(device),
                f32(RANGEFINDER_ANGLES),
                f32([a for a, _ in RADAR_ANGLES]),
                f32([b for _, b in RADAR_ANGLES]),
            )
        return self._consts[device]

    @property
    def _end(self) -> Tuple[float, float]:
        return self.cfg["end"]

    # ------------------------------------------------------------------ api

    def reset(self, B: int, gen: torch.Generator = None, device=None) -> MazeState:
        """Every slot at the start, heading, speed and turn rate 0
        (maze.h:321-332); deterministic, so ``gen`` is not read."""
        z = torch.zeros(B, dtype=torch.float32, device=device)
        sx, sy = self.cfg["start"]
        return MazeState(z + sx, z + sy, z, z, z, torch.zeros(B, dtype=torch.int32, device=device))

    def observe(self, state: MazeState) -> torch.Tensor:
        rf = self._rangefinders(state) / RANGEFINDER_RANGE  # maze.h:560-566
        radar = self._radar(state)  # maze.h:569-573
        return torch.cat([torch.ones_like(rf[:, :1]), rf, radar], dim=1)

    def step(self, state: MazeState, actions: torch.Tensor):
        o1 = torch.clamp(actions[:, 0] + 0.5, 0.0, 1.0)  # tf_maze.cpp:80
        o2 = torch.clamp(actions[:, 1] + 0.5, 0.0, 1.0)
        # interpret_outputs, velocity mode (maze.h:636-658)
        d_ang = torch.clamp((o1 - 0.5) * 6.0 - state.ang_vel, -0.2, 0.2)
        d_speed = torch.clamp((o2 - 0.5) * 6.0 - state.speed, -0.2, 0.2)
        ang_vel = torch.clamp(state.ang_vel + d_ang, -3.0, 3.0)
        speed = torch.clamp(state.speed + d_speed, -3.0, 3.0)
        # Update (maze.h:660-692): the move uses the old heading
        rad = state.heading * _DEG2RAD
        vx = torch.cos(rad) * speed
        vy = torch.sin(rad) * speed
        heading = state.heading + ang_vel
        heading = torch.where(heading > 360.0, heading - 360.0, heading)
        heading = torch.where(heading < 0.0, heading + 360.0, heading)
        nx, ny = state.x + vx, state.y + vy
        blocked = self._collides(nx, ny)  # maze.h:694-702
        x = torch.where(blocked, state.x, nx)
        y = torch.where(blocked, state.y, ny)
        t = state.t + 1
        done = t >= EPISODE_STEPS  # tf_maze.cpp:90-94
        reward = torch.where(done, -self._distance(x, y), torch.zeros_like(x))  # tf_maze.cpp:83-87
        return MazeState(x, y, heading, speed, ang_vel, t), reward, done

    def behavior(self, state: MazeState) -> torch.Tensor:
        return torch.stack([state.x, state.y], dim=1)  # tf_maze.cpp:66-72

    def distance_to_target(self, state: MazeState) -> torch.Tensor:
        return self._distance(state.x, state.y)

    # ------------------------------------------------------------- internals

    def _distance(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        dx, dy = x - self._end[0], y - self._end[1]
        return torch.sqrt(dx * dx + dy * dy)

    def _collides(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """[B] bool: a wall segment within HERO_RADIUS of (x, y)
        (Line::distance, maze.h:264-287; a degenerate segment is at
        distance 0)."""
        segs = self.geometry(x.device)[0]
        ax, ay, bx, by = (segs[:, i] for i in range(4))  # [L]
        x, y = x[:, None], y[:, None]  # [B, 1]
        abx, aby = bx - ax, by - ay
        ab2 = abx * abx + aby * aby
        u = ((x - ax) * abx + (y - ay) * aby) / torch.where(ab2 == 0.0, torch.ones_like(ab2), ab2)
        u = torch.clamp(u, 0.0, 1.0)  # past an end: the distance to that end
        px, py = ax + u * abx, ay + u * aby
        dx, dy = px - x, py - y
        d2 = dx * dx + dy * dy
        d2 = torch.where(ab2 == 0.0, torch.zeros_like(d2), d2)
        return torch.any(d2 < HERO_RADIUS * HERO_RADIUS, dim=1)

    def _rangefinders(self, state: MazeState) -> torch.Tensor:
        """[B, 6]: each ray's nearest wall intersection, or the range
        (maze.h:736-773; a ray at heading + sensor angle). Wall A→B, ray
        C→D, hits with r and s strictly inside (0, 1) (maze.h:216-262)."""
        segs, angles = self.geometry(state.x.device)[:2]
        ang = (angles[None, :] + state.heading[:, None]) * _DEG2RAD  # [B, S]
        dx = torch.cos(ang) * RANGEFINDER_RANGE
        dy = torch.sin(ang) * RANGEFINDER_RANGE
        Ax, Ay, Bx, By = (segs[:, i][None, :, None] for i in range(4))  # [1, L, 1]
        Cx, Cy = state.x[:, None, None], state.y[:, None, None]  # [B, 1, 1]
        Dx, Dy = Cx + dx[:, None, :], Cy + dy[:, None, :]  # [B, 1, S]
        rTop = (Ay - Cy) * (Dx - Cx) - (Ax - Cx) * (Dy - Cy)
        rBot = (Bx - Ax) * (Dy - Cy) - (By - Ay) * (Dx - Cx)
        sTop = (Ay - Cy) * (Bx - Ax) - (Ax - Cx) * (By - Ay)
        safe = torch.where(rBot == 0.0, torch.ones_like(rBot), rBot)  # sBot is rBot (maze.h:231-232)
        r = rTop / safe
        s = sTop / safe
        hit = (rBot != 0.0) & (r > 0.0) & (r < 1.0) & (s > 0.0) & (s < 1.0)
        ix = Ax + r * (Bx - Ax)
        iy = Ay + r * (By - Ay)
        ex, ey = ix - Cx, iy - Cy
        dist = torch.sqrt(ex * ex + ey * ey)
        dist = torch.where(hit, dist, torch.full_like(dist, RANGEFINDER_RANGE))
        return torch.amin(dist, dim=1)  # [B, S]

    def _radar(self, state: MazeState) -> torch.Tensor:
        """[B, 4]: the goal's quadrant in the heading's frame (maze.h:775-811
        update_radar_gen)."""
        lo, hi = self.geometry(state.x.device)[2:]
        rad = -state.heading * _DEG2RAD
        tx = self._end[0] - state.x
        ty = self._end[1] - state.y
        c, s = torch.cos(rad), torch.sin(rad)
        rx = c * tx - s * ty
        ry = s * tx + c * ty
        angle = _point_angle(rx, ry)[:, None]
        fire = ((angle >= lo) & (angle < hi)) | ((angle + 360.0 >= lo) & (angle + 360.0 < hi))
        return fire.to(torch.float32)


register("maze", lambda **kw: MazeEnv(**kw))
