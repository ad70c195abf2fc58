"""Vectorized pixel "Catch" in torch: the conv pipeline's env.

Port of smarties_tpu/envs/catch.py, the stand-in for the reference's
Atari app (apps/OpenAI_gym_atari/exec.py:16-80: 84x84 grayscale frames,
frame stacking, discrete actions, the RACER_atari recipe): the same
interface — 84x84 pixels in {0, 255}, 3 discrete actions, the Mnih conv
stack over 4 stacked frames — with dynamics simple enough to certify the
conv + uint8-replay + ReF-ER pipeline end to end.

Dynamics: a 4x4 ball falls 2 rows per step from a random top column; an
8 px paddle on the bottom rows moves +-3 px by action {left, stay,
right}. The episode ends when the ball reaches the paddle rows (39
steps): reward +1 if they overlap, else -1; optimal play always scores +1.

Tensor functions over a leading env axis. Spawn columns come from a
torch.Generator or are injected (`cols` [n, 2] = ball column, paddle
column). `small` is the same game on a 20x20 board with 3 stacked frames
and two small conv layers (episodes of 7 steps): the pipeline at a size
that a CPU steps quickly.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from smarties_tpu_torch.core.mdp import MDPSpec

H = W = 84
BALL = 4          # ball block size (px)
PADDLE = 8        # paddle width (px)
PADDLE_H = 3      # paddle thickness (px)
FALL = 2          # rows per step
MOVE = 3          # paddle px per step
MAX_STEPS = (H - PADDLE_H - BALL) // FALL + 1   # 39

# the Mnih stack of the RACER_atari recipe: (in_w, in_h, in_c, out_c,
# filter, stride) per layer
CONV_STACK = ((84, 84, 4, 32, 8, 4),
              (20, 20, 32, 64, 4, 2),
              (9, 9, 64, 64, 3, 1))

MDP = MDPSpec(dim_state=H * W, dim_action=1, discrete_values=(3,),
              n_appended_obs=3, conv_layers=CONV_STACK)


class CatchState(NamedTuple):
    ball_col: torch.Tensor    # [V] i32, left edge of the ball
    ball_row: torch.Tensor    # [V] i32, top edge of the ball
    paddle_col: torch.Tensor  # [V] i32, left edge of the paddle
    step: torch.Tensor        # [V] i32


def _spawn(gen, n, device, size=W):
    """[n, 2] i32: ball column in [0, size - BALL], paddle column in
    [0, size - PADDLE]."""
    ball = torch.randint(0, size - BALL + 1, (n,), generator=gen,
                         device=device)
    paddle = torch.randint(0, size - PADDLE + 1, (n,), generator=gen,
                           device=device)
    return torch.stack([ball, paddle], dim=-1).to(torch.int32)


def init(gen: Optional[torch.Generator], n_envs: int, device=None,
         cols: Optional[torch.Tensor] = None, size=W) -> CatchState:
    if cols is None:
        cols = _spawn(gen, n_envs, device, size)
    cols = cols.to(torch.int32)
    # each field in memory of its own: the rollout copies the state back
    # into these tensors field by field (replay/collector.py)
    z = lambda: torch.zeros((n_envs,), dtype=torch.int32, device=cols.device)
    return CatchState(ball_col=cols[:, 0], ball_row=z(),
                      paddle_col=cols[:, 1], step=z())


def observe(state: CatchState, size=W) -> torch.Tensor:
    """[V, size*size] f32 pixels in {0, 255}; the replay stores them as
    uint8 when the Trainer is built with state_dtype=torch.uint8."""
    dev = state.ball_col.device
    rows = torch.arange(size, device=dev)[None, :, None]
    cols = torch.arange(size, device=dev)[None, None, :]
    br = state.ball_row[:, None, None]
    bc = state.ball_col[:, None, None]
    pc = state.paddle_col[:, None, None]
    ball = ((rows >= br) & (rows < br + BALL)
            & (cols >= bc) & (cols < bc + BALL))
    paddle = ((rows >= size - PADDLE_H)
              & (cols >= pc) & (cols < pc + PADDLE))
    img = (ball | paddle).to(torch.float32) * 255.0
    return img.reshape(img.shape[0], -1)


def step(state: CatchState, env_action: torch.Tensor, size=W
         ) -> Tuple[CatchState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Action label {0, 1, 2} -> the paddle moves {-MOVE, 0, +MOVE}."""
    a = env_action[..., 0].to(torch.int32) - 1
    paddle = torch.clamp(state.paddle_col + a * MOVE, 0, size - PADDLE)
    row = state.ball_row + FALL
    done = row + BALL > size - PADDLE_H       # ball reached the paddle rows
    caught = (state.ball_col + BALL > paddle) & \
             (state.ball_col < paddle + PADDLE)
    reward = torch.where(done, torch.where(caught, 1.0, -1.0), 0.0)
    # a true terminal state
    return (CatchState(ball_col=state.ball_col, ball_row=row,
                       paddle_col=paddle, step=state.step + 1),
            reward, done, done)


def reset_where(state: CatchState, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None,
                cols: Optional[torch.Tensor] = None, size=W) -> CatchState:
    if cols is None:
        cols = _spawn(gen, state.step.shape[0], state.step.device, size)
    cols = cols.to(torch.int32)
    z = torch.zeros_like(state.step)
    return CatchState(
        ball_col=torch.where(mask, cols[:, 0], state.ball_col),
        ball_row=torch.where(mask, z, state.ball_row),
        paddle_col=torch.where(mask, cols[:, 1], state.paddle_col),
        step=torch.where(mask, z, state.step))


class small:
    """The game on a 20x20 board: 2 appended frames, two conv layers."""
    SIZE = 20
    MAX_STEPS = (SIZE - PADDLE_H - BALL) // FALL + 1   # 7
    CONV_STACK = ((20, 20, 3, 4, 4, 2), (9, 9, 4, 8, 3, 2))
    MDP = MDPSpec(dim_state=SIZE * SIZE, dim_action=1, discrete_values=(3,),
                  n_appended_obs=2, conv_layers=CONV_STACK)

    @staticmethod
    def init(gen, n_envs, device=None, cols=None):
        return init(gen, n_envs, device, cols, small.SIZE)

    @staticmethod
    def observe(state):
        return observe(state, small.SIZE)

    @staticmethod
    def step(state, env_action):
        return step(state, env_action, small.SIZE)

    @staticmethod
    def reset_where(state, mask, gen=None, cols=None):
        return reset_where(state, mask, gen, cols, small.SIZE)
