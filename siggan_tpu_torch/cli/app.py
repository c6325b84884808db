"""Control-panel CLI.

Usage:
    python -m siggan_tpu_torch.cli.app [--port 8501] [--workdir .] [--device cuda]

Serves the port's control panel (``serve/app.py``) over ``--workdir``
(``checkpoints/``, ``runs/``, ``samples/``, ``data/``). The panel and the
training and preprocessing subprocesses it starts run on ``--device``:
"cuda" (default; several processes share the card) or "cpu". ``--port 0``
picks a free port, which the start-up line prints.
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve the signature GAN control panel")
    p.add_argument("--host", type=str, default="0.0.0.0")
    p.add_argument("--port", type=int, default=8501)
    p.add_argument("--workdir", type=str, default=".",
                   help="root containing checkpoints/, runs/, data/")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.serve.app import serve

    server = serve(args.host, args.port, args.workdir, device=args.device)
    host, port = server.server_address[:2]
    print(f"Control panel on http://{host}:{port} (workdir {args.workdir}, "
          f"device {server.core.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("Shutting down")
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
