"""Binarization serving CLI — keep the checkpoint resident on the card and
serve binarization over HTTP with micro-batched dispatches.

Usage: python -m lecturemath_tpu_torch.cli.serve <config> [-port N]
       [-size WxH] [-batch B] [-window MS] [-device cpu]

See pipeline/server.py for the serving design (one CUDA graph per batch
bucket on the card). The checkpoint (``.dat``/``.pth`` state dict or the
JAX package's ``.msgpack``), widths and upload settings come from the same
config keys stage 01 uses. The server runs on the card unless ``-device
cpu`` is given; without a card it raises.
"""

import os
import sys

from ..core.config import Config, parse_cli_overrides


def main(argv=None):
    argv = sys.argv if argv is None else argv
    if len(argv) < 2:
        print(f"Usage: python {argv[0]} config [-port N] [-size WxH] "
              f"[-batch B] [-window MS] [-device cpu]")
        return

    from ..core.backend_probe import ensure_backend
    from ..core.device import resolve_device
    from ..pipeline.binarize import Binarizer
    from ..pipeline.server import BinarizeService, serve

    config = Config.from_file(argv[1])
    params = parse_cli_overrides(list(argv[2:]))
    device = params.get("device")
    if device is not None and not isinstance(device, str):
        raise ValueError("-device requires a value (e.g. -device cpu)")
    device = resolve_device(device)
    ensure_backend(device=device)

    size_text = str(params.get("size", "960x540"))
    width, height = (int(v) for v in size_text.lower().split("x"))

    def binarizer_factory(checkpoint=None):
        """Fresh Binarizer from the config; POST /reload may point at a
        different checkpoint file (hot weight swap without restart)."""
        if checkpoint is None:
            return Binarizer.from_config(config, device=device)
        override = Config({key: config.get(key) for key in config})
        override.set("BINARIZATION_FCN_LECTURENET_DIR",
                     os.path.dirname(os.path.abspath(checkpoint)))
        override.set("BINARIZATION_FCN_LECTURENET_FILENAME",
                     os.path.basename(checkpoint))
        return Binarizer.from_config(override, device=device)

    service = BinarizeService(
        binarizer_factory(),
        model_size=(width, height),
        max_batch=int(params.get("batch", 8)),
        batch_window_ms=float(params.get("window", 5)),
        binarizer_factory=binarizer_factory)

    server = serve(service, port=int(params.get("port", 8799)))
    host, port = server.server_address
    print(f"Binarize server at http://{host}:{port}/ on {device} "
          f"(model bucket {service.model_size[0]}x{service.model_size[1]}, "
          f"max batch {service.max_batch}; POST /binarize, GET /healthz; "
          f"Ctrl-C to stop)", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nStopping")
    finally:
        server.server_close()
        service.close()


if __name__ == "__main__":
    main()
