"""MDP problem description: state/action spaces, scaling, codecs.

Port of smarties_tpu/core/mdp.py (reference: MDPdescriptor / StateInfo /
ActionInfo, source/smarties/Core/StateAction.h). The static metadata is
plain Python; the device-side mappings are torch functions that keep the
device and dtype of their input. Their constant tensors (masks, scales,
index lists) are made once per device and cached on the spec: a host
array copied to the card at every call would synchronise the host.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class MDPSpec:
    """Static problem description (MDPdescriptor, StateAction.h:47-123).

    - bounded continuous actions are produced by the learner in an
      unbounded space, squashed by tanh and affine-mapped into
      [lower, upper] (StateAction.h:284-295);
    - discrete multi-component actions are flattened to one label with
      mixed-radix shifts (StateAction.h:305-341);
    - only dims with ``observable[i]`` are fed to the network.

    The user state box (setStateScales) arrives with the external-env
    runtime.
    """

    dim_state: int
    dim_action: int
    bounded: Tuple[bool, ...] = ()
    upper_action: Tuple[float, ...] = ()
    lower_action: Tuple[float, ...] = ()
    discrete_values: Tuple[int, ...] = ()
    observable: Tuple[bool, ...] = ()
    n_appended_obs: int = 0
    conv_layers: Tuple[Tuple[int, int, int, int, int, int], ...] = ()
    n_agents_per_env: int = 1
    shared_noise: bool = False

    def __post_init__(self):
        object.__setattr__(self, "_consts", {})
        if not self.observable:
            object.__setattr__(self, "observable",
                               tuple([True] * self.dim_state))
        if not self.is_discrete:
            if not self.bounded:
                object.__setattr__(self, "bounded",
                                   tuple([False] * self.dim_action))
            if not self.upper_action:
                object.__setattr__(self, "upper_action",
                                   tuple([1.0] * self.dim_action))
            if not self.lower_action:
                object.__setattr__(self, "lower_action",
                                   tuple([-1.0] * self.dim_action))

    # ---------------- dimensions ----------------
    @property
    def is_discrete(self) -> bool:
        return len(self.discrete_values) > 0

    @property
    def dim_state_observed(self) -> int:
        return int(sum(self.observable))

    @property
    def dim_net_input(self) -> int:
        return self.dim_state_observed * (1 + self.n_appended_obs)

    @property
    def max_action_label(self) -> int:
        n = 1
        for v in self.discrete_values:
            n *= v
        return n

    @property
    def discrete_shifts(self) -> Tuple[int, ...]:
        """Mixed-radix shifts: shifts[0] = 1, shifts[i] = prod(values[:i])."""
        shifts = [1]
        for v in self.discrete_values[:-1]:
            shifts.append(shifts[-1] * v)
        return tuple(shifts)

    @property
    def dim_policy(self) -> int:
        """Stored behavior-policy size: [means, stdevs] (continuous) or
        option probabilities (discrete)."""
        if self.is_discrete:
            return self.max_action_label
        return 2 * self.dim_action

    # ---------------- static numpy views (host) ----------------
    @property
    def action_scale(self) -> np.ndarray:
        """(upper - lower)/2, StateAction.h:116-119."""
        return (np.asarray(self.upper_action) -
                np.asarray(self.lower_action)) / 2.0

    @property
    def action_shift(self) -> np.ndarray:
        """(upper + lower)/2, StateAction.h:120-122."""
        return (np.asarray(self.upper_action) +
                np.asarray(self.lower_action)) / 2.0

    @property
    def bounded_mask(self) -> np.ndarray:
        return np.asarray(self.bounded, dtype=bool)

    @property
    def observable_mask(self) -> np.ndarray:
        return np.asarray(self.observable, dtype=bool)

    # ---------------- device-side mappings ----------------
    def consts(self, like: torch.Tensor):
        """(observed-index, bounded-mask, action scale, action shift)
        tensors on `like`'s device, scales in its dtype; made once."""
        key = (like.device, like.dtype)
        if key not in self._consts:
            fdt = like.dtype if like.is_floating_point() else torch.float32
            self._consts[key] = (
                torch.as_tensor(np.nonzero(self.observable_mask)[0],
                                device=like.device),
                torch.as_tensor(self.bounded_mask, device=like.device),
                torch.as_tensor(self.action_scale, dtype=fdt,
                                device=like.device),
                torch.as_tensor(self.action_shift, dtype=fdt,
                                device=like.device))
        return self._consts[key]

    def observed(self, state: torch.Tensor) -> torch.Tensor:
        """Select observable dims of a [..., dim_state] state tensor."""
        return state[..., self.consts(state)[0]]

    def learner_to_env_action(self, learner_act: torch.Tensor
                              ) -> torch.Tensor:
        """Unbounded learner action -> env units: scale * tanh(a) + shift
        on bounded dims, scale * a + shift elsewhere
        (ActionInfo::learnerAction2envAction, StateAction.h:284-295)."""
        if self.is_discrete:
            return learner_act
        _, b, scale, shift = self.consts(learner_act)
        squashed = torch.where(b, torch.tanh(learner_act), learner_act)
        return scale * squashed + shift

    def env_to_learner_action(self, env_act: torch.Tensor) -> torch.Tensor:
        """Env action -> unbounded learner space (atanh on bounded dims;
        ActionInfo::envAction2learnerAction, StateAction.h:229-245)."""
        if self.is_discrete:
            return env_act
        _, b, scale, shift = self.consts(env_act)
        descaled = (env_act - shift) / scale
        return torch.where(
            b, torch.atanh(torch.clamp(descaled, -1 + 1e-7, 1 - 1e-7)),
            descaled)

    def _radix(self, like: torch.Tensor):
        """(shifts, values) as int64 tensors on `like`'s device, made once."""
        key = ("radix", like.device)
        if key not in self._consts:
            self._consts[key] = tuple(
                torch.as_tensor(v, dtype=torch.long, device=like.device)
                for v in (self.discrete_shifts, self.discrete_values))
        return self._consts[key]

    def label_to_components(self, label: torch.Tensor) -> torch.Tensor:
        """Discrete label -> per-component option indices [..., nComp]
        (ActionInfo::label2actionMessage, StateAction.h:323-341)."""
        shifts, values = self._radix(label)
        return (label.long()[..., None] // shifts) % values

    def components_to_label(self, comps: torch.Tensor) -> torch.Tensor:
        """Per-component option indices -> flat int32 label
        (ActionInfo::actionMessage2label, StateAction.h:305-321)."""
        shifts, _ = self._radix(comps)
        return torch.sum(comps.long() * shifts, dim=-1).to(torch.int32)
