"""The pixel game catch, decoded from its stored frames, in NumPy.

Its rules: an 84x84 board of pixels in {0, 255}; a 4x4 ball spawns with
its top row at 0 and falls 2 rows a step in its column; an 8 px wide,
3 px high paddle on the bottom rows moves -3, 0 or +3 px under the
actions 0, 1 and 2, held inside the board. The step that brings the
ball's bottom row into the paddle's rows ends the episode, a true
terminal, with reward +1 if ball and paddle overlap in columns and -1
if not; every other step gives 0. An episode that reaches the replay's
max_len steps first is cut there.

Each stored transition is held to these rules on the pixels alone: the
ball's row and column and the paddle's column are read from frame t,
the rules give frame t+1, its reward and whether the episode ends, and
frame t+1 is drawn again from them and compared pixel for pixel; frame
0 must be a fresh spawn. The game is integer arithmetic: every count
is exact.
"""
from __future__ import annotations

import numpy as np

H = W = 84
BALL, PADDLE, PADDLE_H = 4, 8, 3
FALL, MOVE = 2, 3


def decode(frames):
    """(ball row, ball column, paddle column) of frames [..., H, W]: the
    first lit row and column above the paddle's rows, the first lit
    column of the bottom row."""
    above = frames[..., :H - PADDLE_H, :] > 0
    return (np.argmax(above.any(-1), -1), np.argmax(above.any(-2), -1),
            np.argmax(frames[..., H - 1, :] > 0, -1))


def render(ball_row, ball_col, paddle_col):
    """Frames [..., H, W] uint8 of the given positions."""
    r = np.arange(H)[:, None]
    c = np.arange(W)[None, :]
    br, bc, pc = (np.asarray(x)[..., None, None]
                  for x in (ball_row, ball_col, paddle_col))
    ball = (r >= br) & (r < br + BALL) & (c >= bc) & (c < bc + BALL)
    paddle = (r >= H - PADDLE_H) & (c >= pc) & (c < pc + PADDLE)
    return np.where(ball | paddle, 255, 0).astype(np.uint8)


def advance(ball_row, ball_col, paddle_col, action):
    """One step -> (ball row, paddle column, reward, done)."""
    paddle = np.clip(paddle_col + (np.asarray(action, np.int64) - 1) * MOVE,
                     0, W - PADDLE)
    row = ball_row + FALL
    done = row + BALL > H - PADDLE_H
    caught = (ball_col + BALL > paddle) & (ball_col < paddle + PADDLE)
    reward = np.where(done, np.where(caught, 1.0, -1.0), 0.0)
    return row, paddle, reward, done


def transition_gaps(states, actions, rewards, length, terminal):
    """Stored episodes against the rules -> (wrong pixels, wrong rewards
    or ends). states [E, L1, H * W] uint8, actions [E, L1, 1], rewards
    [E, L1], length [E], terminal [E]; max_len is L1 - 1."""
    max_len = states.shape[1] - 1
    pixels, wrong = 0, 0
    for e in range(states.shape[0]):
        T = int(length[e])
        f = states[e, :T + 1].reshape(T + 1, H, W)
        br, bc, pc = decode(f)
        pixels += int(np.sum(render(0, bc[0], pc[0]) != f[0]))
        br1, pc1, r, done = advance(br[:T], bc[:T], pc[:T],
                                    actions[e, :T, 0])
        pixels += int(np.sum(render(br1, bc[:T], pc1) != f[1:]))
        wrong += int(np.sum(r != rewards[e, 1:T + 1]))
        over = done | (np.arange(1, T + 1) >= max_len)
        wrong += int(np.sum(over[:-1])) + int(not over[-1])
        wrong += int(bool(terminal[e]) != bool(done[-1]))
    return pixels, wrong
