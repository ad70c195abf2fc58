"""Cluster submission helper: generate (and optionally submit) a SLURM
batch script that trains with the port's learner ranks. The twin of
bin/smarties_tpu_submit.py.

    python -m smarties_tpu_torch.tools.submit APP [--preset slurm-gpu]
        [--nodes N] [--gpus-per-node G] [--runname R] [--runprefix P]
        [--submit] [launcher arguments ...]

Reference analog: bin/smarties.py's Euler / Piz Daint SLURM presets. The
reference submits MPI rank grids; the port runs one process per learner
rank, joined by torch.distributed (NCCL takes one rank per card,
parallel/multihost.py), so the script starts one SLURM task per card:
it exports MASTER_ADDR (the job's first host), MASTER_PORT and
WORLD_SIZE=$SLURM_NTASKS, and each task sets RANK=$SLURM_PROCID and
LOCAL_RANK=$SLURM_LOCALID (the card launch._run_rank takes) before it
runs `python -m smarties_tpu_torch.launch APP --nLearners nodes*G
--device cuda` with the other launcher arguments passed through (a
passed-through --device comes later and wins, as argparse takes the
last). A passed-through --nLearners that differs from nodes*G is
refused.

Presets:
  --preset slurm      one task per host (G = 1), no GPU request
  --preset slurm-gpu  --gres=gpu:G and --ntasks-per-node=G: one task per
                      card (the counterpart of the JAX tool's slurm-tpu)

The JAX tool's gcp-tpu preset has no counterpart. The script is written
to <runprefix>/<runname>/submit.sh and printed; --submit runs sbatch on
it.
"""
import argparse
import os
import shlex
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

SLURM_TEMPLATE = """#!/bin/bash -l
#SBATCH --job-name={runname}
#SBATCH --output={run_dir}/out.%j.log
#SBATCH --error={run_dir}/err.%j.log
#SBATCH --nodes={nodes}
#SBATCH --ntasks-per-node={tasks}
#SBATCH --cpus-per-task={cpus}
#SBATCH --time={time}
{partition_line}{account_line}{extra_lines}
# one python process per learner rank; torch.distributed wires the ranks
export MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
export MASTER_PORT={port}
export WORLD_SIZE=$SLURM_NTASKS
export PYTHONPATH={repo}${{PYTHONPATH:+:$PYTHONPATH}}

# each task: its rank and its card, then the launcher (its arguments
# reach it as they are quoted here, through "$@")
srun --kill-on-bad-exit=1 bash -c '
  export RANK=$SLURM_PROCID
  export LOCAL_RANK=$SLURM_LOCALID
  exec "$@"
' bash python -m smarties_tpu_torch.launch {app} {launch_args}
"""


def _take_n_learners(passthrough):
    """(the value of a passed-through --nLearners or None, the other
    arguments)."""
    rest, value, i = [], None, 0
    while i < len(passthrough):
        a = passthrough[i]
        if a == "--nLearners" and i + 1 < len(passthrough):
            value, i = passthrough[i + 1], i + 2
            continue
        if a.startswith("--nLearners="):
            value = a.split("=", 1)[1]
        else:
            rest.append(a)
        i += 1
    return value, rest


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m smarties_tpu_torch.tools.submit")
    ap.add_argument("app", help="built-in env name or app script path")
    ap.add_argument("--preset", default="slurm",
                    choices=["slurm", "slurm-gpu"])
    ap.add_argument("--runname", default="run00")
    ap.add_argument("--runprefix", default="runs")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--gpus-per-node", type=int, default=4,
                    help="cards per host under slurm-gpu (one task each)")
    ap.add_argument("--cpus", type=int, default=16)
    ap.add_argument("--time", default="24:00:00")
    ap.add_argument("--partition", default=None)
    ap.add_argument("--account", default=None)
    ap.add_argument("--port", type=int, default=12346)
    ap.add_argument("--submit", action="store_true",
                    help="sbatch the generated script")
    args, passthrough = ap.parse_known_args(argv)

    gpus = args.gpus_per_node if args.preset == "slurm-gpu" else 1
    n_ranks = args.nodes * gpus
    given, passthrough = _take_n_learners(passthrough)
    if given is not None and given != str(n_ranks):
        ap.error(f"--nLearners {given} differs from the {n_ranks} ranks "
                 f"this job starts ({args.nodes} node(s) x {gpus} task(s))")

    run_dir = os.path.join(args.runprefix, args.runname)
    os.makedirs(run_dir, exist_ok=True)
    launch_args = " ".join(
        shlex.quote(a) for a in
        ["--nLearners", str(n_ranks), "--device", "cuda",
         "--runname", args.runname, "--runprefix", args.runprefix]
        + passthrough)
    extra = (f"#SBATCH --gres=gpu:{gpus}\n" if args.preset == "slurm-gpu"
             else "")
    script = SLURM_TEMPLATE.format(
        runname=args.runname, run_dir=run_dir, nodes=args.nodes,
        tasks=gpus, cpus=args.cpus, time=args.time,
        partition_line=(f"#SBATCH --partition={args.partition}\n"
                        if args.partition else ""),
        account_line=(f"#SBATCH --account={args.account}\n"
                      if args.account else ""),
        extra_lines=extra, port=args.port, repo=shlex.quote(REPO),
        app=shlex.quote(args.app), launch_args=launch_args)

    path = os.path.join(run_dir, "submit.sh")
    with open(path, "w") as f:
        f.write(script)
    os.chmod(path, 0o755)
    print(script)
    print(f"# written to {path}", file=sys.stderr)
    if args.submit:
        subprocess.run(["sbatch", path], check=True)
    return script


if __name__ == "__main__":
    main()
