"""Hyperparameter configuration.

Port of smarties_tpu/utils/config.py: the same names, defaults, checks and
json loading (reference: source/smarties/Settings/HyperParameters.{h,cpp},
settings/default.json), so the reference's recipes (settings/*.json) and
the JAX package's recipe dicts load unchanged. Pure Python; duplicated
rather than imported because importing smarties_tpu pulls in jax.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List


@dataclass
class HyperParameters:
    """All learner hyperparameters, reference names and defaults.

    Reference: settings/default.json and HyperParameters.cpp:22-122 (the
    self-documenting json help strings).
    """

    # --- algorithm selection ---
    learner: str = "VRACER"            # RACER/VRACER/PPO/DPG/ACER/NAF/DQN/CMA
    returnsEstimator: str = "default"  # retrace/retraceExplore/GAE/none/default
    ERoldSeqFilter: str = "oldest"     # oldest/farpolfrac/maxkldiv/minerror
    dataSamplingAlgo: str = "uniform"  # uniform/PERrank/PERerr/PERseq

    # --- core learning ---
    gamma: float = 0.995               # discount
    lambda_: float = 0.95              # eligibility-trace / retrace lambda
    learnrate: float = 1e-4            # Adam step size
    batchSize: int = 256
    ESpopSize: int = 1                 # CMA-ES population (1 => gradient-based)
    epsAnneal: float = 0.0             # lr & C annealing rate (annealRate)
    targetDelay: float = 0.0           # >=1: copy-every-K; <1: Polyak tau
    clipImpWeight: float = 4.0         # ReF-ER C (CmaxRet = 1 + anneal(C))
    penalTol: float = 0.1              # ReF-ER D: tolerated frac far-policy
    klDivConstraint: float = 0.01      # PPO/trust-region KL delta
    explNoise: float = 0.4472135955    # initial policy stdev (sqrt(0.2))

    # --- replay ---
    maxTotObsNum: int = 262144
    minTotObsNum: int = 131072
    obsPerStep: float = 1.0            # env steps per grad step (pacing)

    # --- networks ---
    nnLayerSizes: List[int] = field(default_factory=lambda: [128, 128])
    encoderLayerSizes: List[int] = field(default_factory=lambda: [0])
    nnType: str = "FFNN"               # FFNN/RNN/LSTM/GRU
    nnFunc: str = "SoftSign"
    nnOutputFunc: str = "Linear"
    nnBPTTseq: int = 16
    nnLambda: float = 0.0              # L2 penalty coefficient
    outWeightsPrefac: float = 0.1      # output-layer init scale factor
    # JAX-package extension (bf16 matmuls); the port computes in f32
    # only and Trainer rejects True (kept so that configs load unchanged)
    nnBf16: bool = False
    # DQN exploration mode (reference compile switch DQN_USE_POLICY,
    # DQN.cpp:15): False = Boltzmann-over-Q + ReF-ER (the reference's
    # compiled default); True = the paper's eps-greedy branch with
    # constant eps = explNoise (DQN.cpp:71-81, epsAnneal<=0 case)
    dqnEpsGreedy: bool = False
    # NAF advantage parameterization (reference compile switch
    # NAF_ADV_GAUS, NAF.cpp:15-21): True swaps the quadratic advantage
    # for the asymmetric-Gaussian bump (the reference branch is
    # non-compiling bit-rot; algos/naf.py documents the completion)
    nafAdvGaussian: bool = False
    # PPO surrogate mode. False (default) keeps the reference-faithful
    # quirks: the clip test gates on the sign of the RETURN estimate
    # (PPO_train.cpp:41-46) and advantages are used raw. True switches
    # to the standard PPO-clip rule — gate on the sign of the ADVANTAGE
    # (Schulman et al. 2017's min(rho*A, clip(rho)*A) gradient) — and
    # normalizes advantages per batch (documented deviation; the
    # reference recipe never demonstrates learning with the faithful
    # surrogate here either, docs/RESULTS.md)
    ppoStandard: bool = False

    # --- run control ---
    saveFreq: int = 200000
    # NaN-guard debug mode: check training metrics for non-finite values
    # after every train chunk (the reference checks every state/action
    # message host-side, Agent.h:301-313, Communicator.cpp:267-270, and
    # traps FP errors in `config=nans` builds, make.gcc.flags:17-23)
    debugNaN: bool = False

    # --- runtime / topology (reference: CLI flags, ExecutionInfo.cpp:95-170;
    #     here plain config since process topology is replaced by device mesh)
    nEnvironments: int = 1
    totNumSteps: int = 10_000_000      # train grad steps (--nTrainSteps)
    randSeed: int = 0
    bTrain: bool = True

    @property
    def lambda_retrace(self) -> float:
        return self.lambda_

    @classmethod
    def from_json(cls, path_or_str: str) -> "HyperParameters":
        """Load a reference settings/*.json file (identical key names).

        The key "lambda" maps to attribute `lambda_` (python keyword).
        Unknown keys are ignored with a warning, like the reference tolerates
        partial json files (HyperParameters.cpp:124-180 only overrides found
        keys).
        """
        try:
            data = json.loads(path_or_str)
        except (json.JSONDecodeError, ValueError):
            with open(path_or_str) as f:
                data = json.load(f)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: dict) -> "HyperParameters":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in data.items():
            key = "lambda_" if k == "lambda" else k
            if key in known:
                kwargs[key] = v
        return cls(**kwargs)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["lambda"] = d.pop("lambda_")
        return d

    def check(self) -> None:
        """Sanity checks. Reference: HyperParameters::check() (:212-226)."""
        assert 0 < self.gamma <= 1, "gamma must be in (0,1]"  # HyperParameters.cpp:218-219 allows gamma == 1
        assert self.lambda_ >= 0, "lambda must be >= 0"
        assert self.batchSize > 0
        assert self.learnrate > 0
        # an on-policy learner starts when its horizon (maxTotObsNum) is
        # full, whatever minTotObsNum says; the published PPO settings
        # leave it at the default, above the horizon
        assert (self.maxTotObsNum >= self.minTotObsNum
                or self.learner in ("PPO", "GAE")), \
            "maxTotObsNum must be >= minTotObsNum"
        assert self.obsPerStep > 0
        assert self.clipImpWeight >= 0
        assert self.penalTol >= 0

    def distribute(self, n_learners: int) -> "HyperParameters":
        """Split batch/buffer across learner shards.

        Reference: HyperParameters::defineDistributedLearning
        (HyperParameters.cpp:182-210) splits batchSize and buffer bounds
        across learner ranks (kept for config parity; the port runs on one
        device).
        """
        out = dataclasses.replace(self)
        out.batchSize = max(1, self.batchSize // n_learners)
        out.maxTotObsNum = max(1, self.maxTotObsNum // n_learners)
        out.minTotObsNum = max(1, self.minTotObsNum // n_learners)
        return out


def anneal_rate(eta: float, t, time_inv: float):
    """eta / (1 + t * time_inv).

    Reference: Utilities::annealRate (Utils/FunctionUtilities.h:69-72).
    Used for the learning rate and the ReF-ER C annealing.
    Works with python floats or tensors for `t`.
    """
    return eta / (1 + t * time_inv)
