"""Batched Breakout, 96x96 RGB (port of envs/breakout_jax.py).

The reference's breakout and atari games wrap ALE Breakout-v4 with a cv2
resize to 96x96 CHW / 255 (reference games/atari.py:146-160). Like the JAX
package's on-device Breakout, this is a from-scratch Breakout with the same
interface contract: 4 actions (NOOP, FIRE, RIGHT, LEFT: ALE Breakout's
minimal set), (3, 96, 96) float observations in [0, 1], brick rows scoring
7/7/4/4/1/1 from the top, 5 lives. Pixels are drawn with masks over the
whole batch: bricks, then the paddle, then the ball, each overwriting the
ones before.

Randomness: only a serve (FIRE with the ball dead) draws, its horizontal
speed from [-1.5, -1.0, 1.0, 1.5]. `step` draws the choice from `generator`
every step (the JAX env splits a key carried in its state every step), or
takes the indices into that list as `serve` [G]. The state carries no key.
A done state steps on with reward 0.
"""

from typing import NamedTuple, Optional

import torch

from muzero_general_tpu_torch.envs.core import TorchEnv

W = H = 96
PADDLE_W = 12
PADDLE_Y = 90
PADDLE_SPEED = 4
BALL_SIZE = 2
BRICK_ROWS = 6
BRICK_COLS = 16
BRICK_W = W // BRICK_COLS  # 6 px
BRICK_H = 3
BRICK_Y0 = 24
ROW_SCORES = (7.0, 7.0, 4.0, 4.0, 1.0, 1.0)
LIVES = 5
SERVE_VX = (-1.5, -1.0, 1.0, 1.5)
# Brick row colors (loosely the Atari palette), [rows, 3]
ROW_COLORS = (
    (0.78, 0.28, 0.28),
    (0.78, 0.45, 0.28),
    (0.70, 0.64, 0.28),
    (0.64, 0.70, 0.28),
    (0.28, 0.70, 0.28),
    (0.28, 0.45, 0.78),
)


class BreakoutState(NamedTuple):
    paddle_x: torch.Tensor  # [G] f32 center x
    ball_x: torch.Tensor  # [G] f32
    ball_y: torch.Tensor  # [G] f32
    vel_x: torch.Tensor  # [G] f32
    vel_y: torch.Tensor  # [G] f32
    ball_live: torch.Tensor  # [G] bool: the ball is in play (FIRE serves it)
    bricks: torch.Tensor  # [G, rows, cols] bool
    lives: torch.Tensor  # [G] int32
    done: torch.Tensor  # [G] bool


class Breakout(TorchEnv):
    observation_shape = (3, H, W)
    num_actions = 4  # NOOP, FIRE, RIGHT, LEFT (ALE Breakout minimal set)
    num_players = 1

    def __init__(self, device=None):
        super().__init__(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._xs = torch.arange(W, **f32)
        self._ys = torch.arange(H, **f32)
        self._row_colors = torch.tensor(ROW_COLORS, **f32).repeat_interleave(BRICK_H, 0)
        self._row_scores = torch.tensor(ROW_SCORES, **f32)
        self._serve_vx = torch.tensor(SERVE_VX, **f32)

    def reset(self, num_games: int, generator: Optional[torch.Generator] = None,
              start: Optional[torch.Tensor] = None):
        """Every game starts with the ball dead on the centered paddle and a
        full wall (the env draws nothing)."""
        def full(value, dtype=torch.float32):
            return torch.full((num_games,), value, dtype=dtype, device=self.device)

        return BreakoutState(
            paddle_x=full(W / 2), ball_x=full(W / 2), ball_y=full(PADDLE_Y - 2),
            vel_x=full(0.0), vel_y=full(0.0), ball_live=full(False, torch.bool),
            bricks=torch.ones((num_games, BRICK_ROWS, BRICK_COLS), dtype=torch.bool,
                              device=self.device),
            lives=full(LIVES, torch.int32), done=full(False, torch.bool),
        )

    def observation(self, state):
        """[G, 3, 96, 96] float RGB in [0, 1]."""
        g = state.paddle_x.shape[0]
        img = torch.zeros((g, H, W, 3), dtype=torch.float32, device=self.device)
        # Bricks: the [rows, cols] grid upsampled into pixel bands
        bricks = state.bricks.to(torch.float32).repeat_interleave(BRICK_H, 1)
        bricks = bricks.repeat_interleave(BRICK_W, 2)  # [G, rows * 3, 96]
        img[:, BRICK_Y0:BRICK_Y0 + BRICK_ROWS * BRICK_H] = (
            bricks[..., None] * self._row_colors[None, :, None, :])
        # Paddle (grey)
        px = torch.clamp(state.paddle_x, PADDLE_W / 2, W - PADDLE_W / 2)
        paddle = ((torch.abs(self._xs[None, None, :] - px[:, None, None]) <= PADDLE_W / 2)
                  & (torch.abs(self._ys[None, :, None] - PADDLE_Y) <= 1))
        img = torch.where(paddle[..., None], 0.7, img)
        # Ball (white)
        ball = ((torch.abs(self._xs[None, None, :] - state.ball_x[:, None, None])
                 <= BALL_SIZE / 2)
                & (torch.abs(self._ys[None, :, None] - state.ball_y[:, None, None])
                   <= BALL_SIZE / 2))
        img = torch.where(ball[..., None], 1.0, img)
        return img.permute(0, 3, 1, 2).contiguous()

    def step(self, state, action, generator: Optional[torch.Generator] = None,
             serve: Optional[torch.Tensor] = None):
        """serve: optional [G] int, each game's index into SERVE_VX should it
        serve this step; otherwise drawn from `generator`."""
        g = state.paddle_x.shape[0]
        if serve is None:
            serve = torch.randint(0, len(SERVE_VX), (g,), generator=generator,
                                  device=self.device)
        vx_serve = self._serve_vx[torch.as_tensor(serve, device=self.device).long()]
        # Paddle motion (2 = RIGHT, 3 = LEFT)
        px = state.paddle_x + torch.where(
            action == 2, PADDLE_SPEED, torch.where(action == 3, -PADDLE_SPEED, 0))
        px = torch.clamp(px, PADDLE_W / 2, W - PADDLE_W / 2)

        # FIRE serves the ball when dead
        serving = (action == 1) & ~state.ball_live
        vx = torch.where(serving, vx_serve, state.vel_x)
        vy = torch.where(serving, -1.5, state.vel_y)
        live = state.ball_live | serving

        bx = torch.where(live, state.ball_x + vx, px)
        by = torch.where(live, state.ball_y + vy, PADDLE_Y - 2.0)

        # Wall bounces
        vx = torch.where((bx <= 1) | (bx >= W - 2), -vx, vx)
        bx = torch.clamp(bx, 1, W - 2)
        vy = torch.where(by <= 1, -vy, vy)
        by = torch.clamp(by, min=1)

        # Paddle bounce with angle control by hit offset
        hit_paddle = (live & (vy > 0) & (torch.abs(by - PADDLE_Y) <= 2)
                      & (torch.abs(bx - px) <= PADDLE_W / 2 + 1))
        offset = torch.clamp((bx - px) / (PADDLE_W / 2), -1.0, 1.0)
        vy = torch.where(hit_paddle, -torch.abs(vy), vy)
        vx = torch.where(hit_paddle, offset * 1.8 + 0.2 * vx, vx)

        # Brick collision: the cell the ball is in. The casts truncate
        # toward zero, as the JAX env's astype(int32) does: a ball just
        # above the band is in row 0, not row -1.
        row = ((by - BRICK_Y0) / BRICK_H).to(torch.int32)
        col = (bx / BRICK_W).to(torch.int32)
        in_band = (row >= 0) & (row < BRICK_ROWS) & live
        row_c = torch.clamp(row, 0, BRICK_ROWS - 1).long()
        col_c = torch.clamp(col, 0, BRICK_COLS - 1).long()
        lanes = torch.arange(g, device=self.device)
        cell = state.bricks[lanes, row_c, col_c]
        hit_brick = in_band & cell
        bricks = state.bricks.clone()
        bricks[lanes, row_c, col_c] = cell & ~hit_brick
        reward = torch.where(hit_brick, self._row_scores[row_c], 0.0)
        vy = torch.where(hit_brick, -vy, vy)

        # Ball lost below the paddle
        lost = live & (by > H - 2)
        lives = state.lives - lost.to(torch.int32)
        live = live & ~lost

        cleared = ~bricks.flatten(1).any(1)
        done_now = (lives <= 0) | cleared
        reward = torch.where(state.done, 0.0, reward)

        new_state = BreakoutState(
            paddle_x=px, ball_x=bx, ball_y=by, vel_x=vx, vel_y=vy, ball_live=live,
            bricks=bricks, lives=lives, done=state.done | done_now,
        )
        return new_state, reward, new_state.done

    def action_to_string(self, action):
        return f"{action}. {['NOOP', 'FIRE', 'RIGHT', 'LEFT'][int(action)]}"
