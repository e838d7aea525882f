"""A rank of ``tests/test_torch_sharding.py``'s process group, started by
``torch.distributed.run``:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        tests/_torch_launch_ranks.py OUT_DIR CKPT_DIR -- LAUNCHER_ARGS...

Runs the training launcher (``repro_torch.launch.train.main``, which
starts the process group from the environment), then restores the
checkpoint in ``CKPT_DIR`` onto ``P("data", None)`` on the launcher's
host mesh, and writes ``OUT_DIR/rank<r>.json``.  Imports torch and the
port only.
"""

from __future__ import annotations

import json
import os
import sys

import torch


def main() -> None:
    torch.set_num_threads(1)
    out_dir, ckpt_dir = sys.argv[1], sys.argv[2]
    argv = sys.argv[sys.argv.index("--") + 1:]
    from repro_torch.ckpt import checkpoint as CKPT
    from repro_torch.core import conv as C
    from repro_torch.dist.sharding import P
    from repro_torch.launch import mesh as LM
    from repro_torch.launch import train as launch
    hist: list = []
    losses = launch.main(argv, history=hist)
    events = {k: v for k, v in C.dispatch_events().items()
              if k.startswith("mesh")}
    mesh = LM.make_host_mesh()
    step, tree = CKPT.restore(ckpt_dir, device="cpu", mesh=mesh,
                              specs={"w": P("data", None), "b": P()})
    out = {"rank": LM.rank(), "world": mesh.size, "mesh": mesh.shape,
           "backend": mesh.backend, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist], "events": events,
           "restored_step": step, "w": tree["w"].tolist(),
           "b": tree["b"].tolist()}
    with open(os.path.join(out_dir, f"rank{out['rank']}.json"), "w") as f:
        json.dump(out, f)
    LM.shutdown()


if __name__ == "__main__":
    main()
