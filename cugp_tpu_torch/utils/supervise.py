"""Failure detection and elastic restart, as ``cugp_tpu/utils/supervise.py``.

A copy of the JAX package's supervisor, whose default child is the
port's CLI:

  - liveness signal: the child's JSON-lines metrics file (utils/metrics.py,
    CLI --metrics_file) doubles as a HEARTBEAT: its mtime advances every
    time the child logs;
  - failure detection: the supervisor declares the child dead when the
    heartbeat stalls past --timeout (a hung build or device) or the
    process exits nonzero (a crash);
  - recovery: kill the process group and relaunch the SAME command; the
    command's own --checkpoint_dir resume (MAP params via GP.load, the
    iterative fit's optimizer state, the sampler's chain state via
    sample_hyperparams_checkpointed) continues the work instead of
    restarting it.

Usage:
  python -m cugp_tpu_torch.utils.supervise --timeout=120 --max_restarts=3 \\
      --heartbeat=/tmp/hb.jsonl -- \\
      fit --data.n=8000 --checkpoint_dir=/tmp/ck --metrics_file=/tmp/hb.jsonl

Everything after `--` is a cugp_tpu_torch.cli command line (or pass
--cmd=python,-m,... for an arbitrary program).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time


def _heartbeat_age(path):
    try:
        return time.time() - os.path.getmtime(path)
    except OSError:
        return None  # no heartbeat yet


def supervise(cmd, heartbeat, timeout=120.0, max_restarts=3, poll=1.0,
              grace=None, _log=print):
    """Run cmd under heartbeat supervision. Returns the final exit code.

    cmd: argv list for the child. heartbeat: file whose mtime the child
    advances (e.g. its --metrics_file). timeout: seconds of heartbeat
    silence before the child is declared hung (the clock only starts once
    the file first appears, so long first-compiles don't false-trigger —
    bound those with `grace`, the max seconds allowed before the FIRST
    heartbeat; None = unlimited).
    """
    restarts = 0
    while True:
        start = time.time()
        proc = subprocess.Popen(cmd, start_new_session=True)
        verdict = None  # "exit" | "hung"
        while True:
            rc = proc.poll()
            if rc is not None:
                verdict = "exit"
                break
            age = _heartbeat_age(heartbeat)
            if age is not None:
                # a heartbeat file surviving from a previous run must not
                # instantly condemn the fresh child: measure silence from
                # the later of (last beat, this run's start)
                age = min(age, time.time() - start)
            if age is None:
                if grace is not None and time.time() - start > grace:
                    verdict = "hung"
                    break
            elif age > timeout:
                verdict = "hung"
                break
            time.sleep(poll)

        if verdict == "exit" and proc.returncode == 0:
            _log(json.dumps({"supervisor": "done", "restarts": restarts}))
            return 0
        if verdict == "hung":
            # kill the whole process group (never by pattern)
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        reason = ("heartbeat stalled" if verdict == "hung"
                  else f"exit code {proc.returncode}")
        if restarts >= max_restarts:
            _log(json.dumps({"supervisor": "giving_up", "reason": reason,
                             "restarts": restarts}))
            return proc.returncode if verdict == "exit" else 124
        restarts += 1
        _log(json.dumps({"supervisor": "restarting", "reason": reason,
                         "restart": restarts}))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    child = None
    for i, a in enumerate(argv):
        if a == "--":
            child = argv[i + 1:]
            argv = argv[:i]
            break
    for a in argv:
        if a.startswith("--") and "=" in a:
            k, v = a[2:].split("=", 1)
            opts[k] = v
    if child is None and "cmd" not in opts:
        print(__doc__, file=sys.stderr)
        return 2
    if child is not None:
        cmd = [sys.executable, "-m", "cugp_tpu_torch.cli"] + child
    else:
        cmd = opts["cmd"].split(",")
    heartbeat = opts.get("heartbeat")
    if heartbeat is None:
        for a in cmd:
            if a.startswith("--metrics_file="):
                heartbeat = a.split("=", 1)[1]
    if heartbeat is None:
        print("need --heartbeat= or a --metrics_file= in the child command",
              file=sys.stderr)
        return 2
    return supervise(
        cmd, heartbeat,
        timeout=float(opts.get("timeout", 120)),
        max_restarts=int(opts.get("max_restarts", 3)),
        poll=float(opts.get("poll", 1.0)),
        grace=float(opts["grace"]) if "grace" in opts else None,
    )


if __name__ == "__main__":
    sys.exit(main())
