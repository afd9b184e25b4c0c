"""The command-line entry points on a machine without a GPU.

Every entry point that measures names its device and refuses to run
without a GPU unless the caller asked for a CPU rehearsal with
JAX_PLATFORMS=cpu; a rehearsal never prints a number under a device
metric's name. chip_smoke.py fails outright without a GPU.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, env_update=None, drop=(), timeout=600):
    env = dict(os.environ)
    env.update(env_update or {})
    for key in drop:
        env.pop(key, None)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_chip_smoke_fails_without_gpu():
    p = _run(["chip_smoke.py"], {"JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no GPU" in p.stdout + p.stderr


def test_bench_refuses_cpu_without_opt_in():
    p = _run(["bench.py"], drop=("JAX_PLATFORMS",))
    assert p.returncode != 0
    assert "no GPU" in p.stderr


def test_bench_cpu_rehearsal_prints_no_device_number():
    p = _run(["bench.py"], {"JAX_PLATFORMS": "cpu", "BENCH_PAIRS": "512",
                            "BENCH_REPS": "1"})
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "cpu"
    assert line["value"] is None and line["pairs"] == 512
    assert all(ln.startswith("[cpu]") for ln in p.stderr.splitlines()
               if ln.startswith("["))


def test_harness_cli_rehearsal_names_cpu():
    p = _run(["-m", "asm_tpu.bench", "--pairs", "256", "--err", "0.05",
              "--chunk", "128"], {"JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert "device: platform=cpu" in p.stdout
    times = [ln for ln in p.stdout.splitlines() if "aligns/s" in ln]
    assert len(times) == 3 and all("on cpu" in ln for ln in times)
