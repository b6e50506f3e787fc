"""Regenerate the port's protobuf module, ``service/_proto/herdsman_pb2.py``,
from the repo's ``proto/herdsman.proto`` with ``protoc``.

Nothing imports this at run time: the generated module is committed, and
the port imports it by its package path.  ``protoc`` 3.21 writes the file
that is committed (byte for byte the JAX package's copy); its descriptor
must stay byte-identical to the JAX package's, because both register the
same file in protobuf's default descriptor pool (``_proto/__init__.py``).

Run: python -m herdsman_tpu_torch.service.proto_build
"""

from __future__ import annotations

import pathlib
import subprocess

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent
OUT = pathlib.Path(__file__).resolve().parent / "_proto"


def build(out: pathlib.Path = OUT) -> pathlib.Path:
    """Run ``protoc`` on ``proto/herdsman.proto`` into ``out``; returns the
    generated file's path."""
    subprocess.run(
        ["protoc", f"-I{ROOT / 'proto'}", f"--python_out={out}",
         str(ROOT / "proto" / "herdsman.proto")],
        check=True,
    )
    return out / "herdsman_pb2.py"


if __name__ == "__main__":
    print(f"generated {build()}")
