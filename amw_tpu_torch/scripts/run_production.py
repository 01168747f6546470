#!/usr/bin/env python
"""Production entry of the port's HTTP service.

    AMW_HOST=0.0.0.0 AMW_PORT=8000 python -m amw_tpu_torch.scripts.run_production

One process (the job store lives in memory, so one worker serves): the
service of ``runtime/service.main`` on ``AMW_HOST`` (default
``0.0.0.0``) and ``AMW_PORT`` (default 8000), its graphs shared through
the in-process engine on ``--device`` (``cuda`` unless given; raises
without a GPU), as the JAX package's ``scripts/run_production.py``
starts its service.  ``deploy/systemd/amw-tpu-torch.service`` starts the
same service as ``python -m amw_tpu_torch.runtime.service``.
"""

from __future__ import annotations

import argparse
import os

from amw_tpu_torch import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    from amw_tpu_torch.runtime import service

    host = os.environ.get("AMW_HOST", "0.0.0.0")
    port = int(os.environ.get("AMW_PORT", "8000"))
    service.main(host=host, port=port, device=dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
