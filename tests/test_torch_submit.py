"""The port's SLURM script generator (smarties_tpu_torch/tools/submit.py),
the twin of bin/smarties_tpu_submit.py. No sbatch is run.

- The text of both presets: the SBATCH lines (one task per host, or
  --gres=gpu:G with one task per card), MASTER_ADDR / MASTER_PORT /
  WORLD_SIZE, RANK and LOCAL_RANK from SLURM's task ids, the launcher
  module with --nLearners nodes x G and the passed-through arguments,
  the run directory's layout (<runprefix>/<runname>/submit.sh).
- The generated script run under bash with stand-ins for scontrol, srun
  and python: every task gets its rank, its card and the arguments as
  they were given (a settings json with spaces and quotes included).
- A passed-through --nLearners that differs is refused; an equal one is
  taken once; the JAX tool's gcp-tpu preset is rejected.
"""
import os
import shlex
import subprocess

import pytest

from smarties_tpu_torch.tools import submit


def _script(tmp_path, *argv):
    text = submit.main([*argv, "--runprefix", str(tmp_path)])
    path = tmp_path / "run00" / "submit.sh"
    assert path.read_text() == text and os.access(path, os.X_OK)
    return text


def test_slurm_preset_text(tmp_path):
    text = _script(tmp_path, "cartpole", "--nodes", "3",
                   "--partition", "p1", "--recipe", "VRACER")
    lines = text.splitlines()
    assert lines[0] == "#!/bin/bash -l"
    for want in ("#SBATCH --job-name=run00", "#SBATCH --nodes=3",
                 "#SBATCH --ntasks-per-node=1", "#SBATCH --cpus-per-task=16",
                 "#SBATCH --time=24:00:00", "#SBATCH --partition=p1",
                 f"#SBATCH --output={tmp_path}/run00/out.%j.log",
                 "export MASTER_PORT=12346",
                 "export WORLD_SIZE=$SLURM_NTASKS",
                 "  export RANK=$SLURM_PROCID",
                 "  export LOCAL_RANK=$SLURM_LOCALID"):
        assert want in lines, want
    assert not any("--gres" in l for l in lines)
    assert any(l.startswith("export MASTER_ADDR=$(scontrol show hostnames")
               for l in lines)
    run = lines[-1]
    assert run.startswith("' bash python -m smarties_tpu_torch.launch "
                          "cartpole --nLearners 3 --device cuda")
    assert run.endswith(f"--runprefix {tmp_path} --recipe VRACER")


def test_slurm_gpu_preset_text(tmp_path):
    text = _script(tmp_path, "glider", "--preset", "slurm-gpu", "--nodes",
                   "2", "--gpus-per-node", "8", "--account", "a1")
    lines = text.splitlines()
    for want in ("#SBATCH --nodes=2", "#SBATCH --ntasks-per-node=8",
                 "#SBATCH --gres=gpu:8", "#SBATCH --account=a1"):
        assert want in lines, want
    assert "--nLearners 16 --device cuda" in lines[-1]


def _fake_bin(tmp_path):
    """scontrol, srun (one task: the given ids) and python (prints its
    environment's rank variables and its arguments, one per line)."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    scripts = {
        "scontrol": 'printf "host-a\\nhost-b\\n"',
        "srun": ('while [ "${1#--}" != "$1" ]; do shift; done\n'
                 'SLURM_PROCID=5 SLURM_LOCALID=1 exec "$@"'),
        "python": ('echo "$MASTER_ADDR $MASTER_PORT $WORLD_SIZE $RANK '
                   '$LOCAL_RANK"\nfor a in "$@"; do echo "$a"; done'),
    }
    for name, body in scripts.items():
        p = bin_dir / name
        p.write_text("#!/bin/bash\n" + body + "\n")
        p.chmod(0o755)
    return bin_dir


def test_script_runs_each_task_with_its_rank(tmp_path):
    recipe = '{"nnLayerSizes": [16], "learner": "VRACER"}'
    _script(tmp_path, "apps/cart pole/exec.py", "--preset", "slurm-gpu",
            "--nodes", "2", "--gpus-per-node", "4", "--recipe", recipe)
    env = dict(os.environ, PATH=f"{_fake_bin(tmp_path)}:{os.environ['PATH']}",
               SLURM_JOB_NODELIST="host-[a-b]", SLURM_NTASKS="8")
    out = subprocess.run(["bash", str(tmp_path / "run00" / "submit.sh")],
                         env=env, capture_output=True, text=True,
                         timeout=60, check=True).stdout.splitlines()
    assert out[0] == "host-a 12346 8 5 1"
    assert out[1:] == ["-m", "smarties_tpu_torch.launch",
                       "apps/cart pole/exec.py", "--nLearners", "8",
                       "--device", "cuda", "--runname", "run00",
                       "--runprefix", str(tmp_path), "--recipe", recipe]


@pytest.mark.parametrize("given", [["--nLearners", "4"], ["--nLearners=2"]])
def test_mismatched_n_learners_refused(tmp_path, given):
    with pytest.raises(SystemExit) as e:
        submit.main(["cartpole", "--preset", "slurm-gpu", "--nodes", "2",
                     "--gpus-per-node", "4", "--runprefix", str(tmp_path),
                     *given])
    assert e.value.code == 2
    assert not (tmp_path / "run00" / "submit.sh").exists()


def test_equal_n_learners_taken_once(tmp_path):
    text = _script(tmp_path, "cartpole", "--nodes", "2", "--nLearners", "2")
    args = shlex.split(text.splitlines()[-1][1:])   # after the quote
    assert args.count("--nLearners") == 1
    assert args[args.index("--nLearners") + 1] == "2"


def test_gcp_tpu_preset_rejected(tmp_path):
    with pytest.raises(SystemExit):
        submit.main(["cartpole", "--preset", "gcp-tpu", "--runprefix",
                     str(tmp_path)])
