"""API server CLI.

Usage:
    python -m siggan_tpu_torch.cli.serve --checkpoint DIR [--port 8000] [--device cuda]

``DIR`` is a port checkpoint (``config.json`` + ``generator.npz``).
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Serve the signature GAN REST API")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint directory (default: $GAN_CHECKPOINT_PATH "
                        "or ./checkpoints)")
    p.add_argument("--host", type=str, default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_arguments(argv)
    from siggan_tpu_torch.serve.api import serve

    server = serve(args.host, args.port, args.checkpoint, device=args.device)
    host, port = server.server_address[:2]
    core = server.core
    print(f"Serving on http://{host}:{port} "
          f"(model_loaded={core.state.loaded}"
          + (f", load_error={core.state.load_error}" if core.state.load_error
             else "") + ")", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("Shutting down")
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
