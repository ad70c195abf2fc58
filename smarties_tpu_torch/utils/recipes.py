"""Reference hyperparameter recipes, as python dicts.

Port of smarties_tpu/utils/recipes.py, with the same dicts. They
reproduce the reference's published settings files (settings/*.json:
default, VRACER, RACER, RACER_atari, RACER_RNN, PPO, DPG, DQN, NAF, ACER,
CMA — values documented in BASELINE.md) so that
`HyperParameters.from_dict(RECIPES[name])` gives the exact recipe. Only
keys that differ from the HyperParameters defaults (which mirror
settings/default.json) are listed.
"""
from smarties_tpu_torch.utils.config import HyperParameters

RECIPES = {
    # settings/default.json == HyperParameters defaults
    "default": {},
    # settings/VRACER.json
    "VRACER": {"learner": "VRACER", "dataSamplingAlgo": "uniform",
               "returnsEstimator": "retrace", "ERoldSeqFilter": "oldest",
               "nnLayerSizes": [128, 128]},
    # settings/RACER.json (same hyperparameters, Gaussian advantage)
    "RACER": {"learner": "RACER", "returnsEstimator": "retrace",
              "nnLayerSizes": [128, 128]},
    # settings/RACER_atari.json
    "RACER_atari": {"learner": "RACER", "batchSize": 128,
                    "clipImpWeight": 4, "explNoise": 0.05, "gamma": 0.99,
                    "learnrate": 1e-4, "maxTotObsNum": 262144,
                    "minTotObsNum": 131072, "nnLayerSizes": [512]},
    # settings/RACER_RNN.json
    "RACER_RNN": {"learner": "VRACER", "nnType": "LSTM",
                  "nnLayerSizes": [32, 32], "nnBPTTseq": 16,
                  "batchSize": 128, "clipImpWeight": 4},
    # settings/PPO.json
    "PPO": {"learner": "PPO", "batchSize": 64, "clipImpWeight": 0.2,
            "encoderLayerSizes": [64], "epsAnneal": 0, "gamma": 0.995,
            "lambda": 0.97, "obsPerStep": 6.4, "learnrate": 1e-4,
            "maxTotObsNum": 2048, "nnLayerSizes": [64],
            "klDivConstraint": 0.01},
    # settings/DPG.json
    "DPG": {"learner": "DPG", "returnsEstimator": "retrace",
            "batchSize": 128, "encoderLayerSizes": [128],
            "epsAnneal": 5e-7, "explNoise": 0.2, "gamma": 0.995,
            "learnrate": 1e-5, "nnLayerSizes": [128],
            "targetDelay": 0.001},
    # settings/DQN.json
    "DQN": {"learner": "DQN", "batchSize": 128, "clipImpWeight": 0,
            "epsAnneal": 0, "explNoise": 0.05, "gamma": 0.99,
            "learnrate": 1e-4, "maxTotObsNum": 524288,
            "minTotObsNum": 131072, "nnLayerSizes": [128, 128],
            "targetDelay": 1e-4},
    # settings/NAF.json
    "NAF": {"learner": "NAF", "returnsEstimator": "retrace",
            "batchSize": 256, "epsAnneal": 5e-7, "explNoise": 0.2,
            "gamma": 0.995, "learnrate": 1e-4, "nnLayerSizes": [128, 128],
            "targetDelay": 1e-4},
    # settings/ACER.json
    "ACER": {"learner": "ACER", "batchSize": 24, "clipImpWeight": 5,
             "encoderLayerSizes": [128], "epsAnneal": 5e-7,
             "explNoise": 0.4472135955, "gamma": 0.995,
             "klDivConstraint": 1, "learnrate": 1e-5,
             "maxTotObsNum": 131072, "minTotObsNum": 131072,
             "nnLayerSizes": [128], "targetDelay": 0.001},
    # settings/CMA.json
    "CMA": {"learner": "CMA", "ESpopSize": 12, "batchSize": 32,
            "explNoise": 0.1, "gamma": 0.99, "learnrate": 0.01,
            "maxTotObsNum": 64000, "nnLayerSizes": [64, 64]},
    # settings/VRACER_CMA.json (derivative-free V-RACER, ES population)
    "VRACER_CMA": {"learner": "VRACER", "batchSize": 60, "ESpopSize": 60,
                   "clipImpWeight": 4, "epsAnneal": 0,
                   "explNoise": 0.447214, "gamma": 0.995,
                   "learnrate": 0.001, "maxTotObsNum": 262144,
                   "nnLayerSizes": [64, 64], "obsPerStep": 1,
                   "outWeightsPrefac": 0.01},
    # settings/RACER_glider.json
    "RACER_glider": {"learner": "RACER", "nnLayerSizes": [128, 128, 128],
                     "gamma": 1.0, "epsAnneal": 2e-7, "nnLambda": 1e-6,
                     "penalTol": 0.05, "clipImpWeight": 1,
                     "maxTotObsNum": 524288},
    # settings/DPG_light.json
    "DPG_light": {"learner": "DPG", "batchSize": 32, "clipImpWeight": 4,
                  "encoderLayerSizes": [32], "epsAnneal": 5e-7,
                  "explNoise": 0.2, "gamma": 0.99, "learnrate": 1e-6,
                  "maxTotObsNum": 262144, "minTotObsNum": 65536,
                  "nnLayerSizes": [32], "targetDelay": 0.001},
    # settings/DPG_orig.json (no ReF-ER clipping)
    "DPG_orig": {"learner": "DPG", "batchSize": 128, "clipImpWeight": 0,
                 "encoderLayerSizes": [128], "epsAnneal": 0,
                 "explNoise": 0.2, "gamma": 0.995, "learnrate": 1e-5,
                 "maxTotObsNum": 262144, "minTotObsNum": 131072,
                 "nnLayerSizes": [128], "targetDelay": 0.001},
    # settings/VRACER_LES.json (large-eddy-simulation runs)
    "VRACER_LES": {"learner": "VRACER", "batchSize": 256,
                   "clipImpWeight": 1, "epsAnneal": 0, "penalTol": 0.05,
                   "explNoise": 0.5, "gamma": 0.99, "learnrate": 1e-5,
                   "minTotObsNum": 1048576, "maxTotObsNum": 1048576,
                   "nnLayerSizes": [32, 32], "obsPerStep": 64,
                   "ERoldSeqFilter": "oldest",
                   "outWeightsPrefac": 1e-5},
    # settings/VRACER_expensiveData.json (GRU, small replay, slow envs)
    "VRACER_expensiveData": {"learner": "VRACER", "batchSize": 128,
                             "clipImpWeight": 1, "penalTol": 0.1,
                             "epsAnneal": 0, "explNoise": 0.2,
                             "gamma": 0.99, "learnrate": 1e-4,
                             "minTotObsNum": 4096, "maxTotObsNum": 32768,
                             "nnLayerSizes": [32, 32], "nnType": "GRU",
                             "saveFreq": 10000, "obsPerStep": 1,
                             "outWeightsPrefac": 0.01},
}


def recipe(name: str) -> HyperParameters:
    return HyperParameters.from_dict(RECIPES[name])
