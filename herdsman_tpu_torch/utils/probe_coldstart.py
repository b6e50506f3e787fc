"""Cold-start probe: where a fresh worker process's time goes before its
first result (the port's counterpart of the JAX package's
``scripts/probe_coldstart.py``).

Run it in a fresh interpreter on a server key file (the coordinator's key
file, ``service.coordinator.serialize_server_key``'s bytes):

    python -m herdsman_tpu_torch.utils.probe_coldstart --key FILE \\
        [--engine mega13] [--batch 512] [--device cuda]

It pays what an offload worker pays for its first task
(``service/offload_worker.py``: ``_session``, ``_compiled``, ``run_task``)
and prints one line per phase, on the host clock, each phase ended by a
synchronize:

1. ``import torch``, then the port's service modules;
2. the CUDA context;
3. the key file's read and ``deserialize_server_key``;
4. ``device_server_key`` with the engine's layouts (``fit_engine``);
5. ``compile_circuit`` of the coordinator's test job's map circuit (x = a
   XOR b, odd = the parity of x, over two UINT8 columns);
6. the first call on ``--batch`` rows of random ciphertexts made from
   ``--seed`` (the work does not depend on the data), split into each
   ``_build.load`` of a library, the first rotation (host time without the
   loads, beside CUDA events; the host time of its ``rotation_inputs``, the
   PyTorch ops before the engine, apart), the first key switch's
   ``torch._int_mm`` (host time beside CUDA events) and the rest;
7. a second, warm call, split alike; its output must equal the first's.

With ``--layouts-file PATH`` the probe weighs a disk cache of the device
key against building it: where PATH is missing it runs as above and then
saves the device key's tensors there (``torch.save``); where PATH exists,
phase 4 is "device layouts from the file", the tensors read back with
``torch.load(weights_only=True)`` onto the device.  Run it in turns, each
run a fresh interpreter, to compare the two.

The last line is one JSON object of every phase's seconds.  The probe
times each rotation, key switch and ``torch._int_mm`` by wrapping them
with a synchronize on each side, so the calls' host and device work do not
overlap as they do unprobed.

The JAX probe's ``save`` and ``aot`` phases have no counterpart: the JAX
package serializes compiled XLA executables (``ops/aot.py``), and the port
compiles nothing at run time.  Its only compiled artefacts are the
libraries of ``ops/kernels/_build.py``, built ahead and cached across
processes in ``_build/``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time

# the probe's start: its first phase, ``import torch``, is timed from here
T0 = time.perf_counter()

# the phases, in the order the probe prints them
PHASES = ("import torch", "import the port's service modules",
          "CUDA context", "read the key file", "deserialize_server_key",
          "device_server_key", "compile_circuit", "first call",
          "first call: _build.load", "first call: first rotation",
          "first call: first key switch's torch._int_mm",
          "first call: the rest", "second call",
          "second call: first rotation",
          "second call: first key switch's torch._int_mm",
          "second call: the rest")


class _Probe:
    """Wraps the functions a call runs to time them: each ``_build.load``,
    each rotation (``bootstrap.blind_rotate_batch``: host seconds without
    the loads it made, CUDA milliseconds, and the host seconds of its
    ``bootstrap.rotation_inputs``, the PyTorch ops before the engine) and
    each ``torch._int_mm`` of a key switch (``mega13.int8_matmul`` inside
    ``bootstrap.key_switch_batch``)."""

    def __init__(self, torch, device):
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.loads: list[tuple[str, float]] = []
        self.rotations: list[tuple[float, float | None, float]] = []
        self.inputs: list[float] = []
        self.int_mms: list[tuple[float, float | None]] = []
        self._in_key_switch = 0

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def _timed(self, fn, *args, **kwargs):
        """(fn's result, host seconds, CUDA milliseconds or None)."""
        self.sync()
        if self.cuda:
            start, end = (self.torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if self.cuda:
            end.record()
        self.sync()
        host = time.perf_counter() - t0
        return out, host, start.elapsed_time(end) if self.cuda else None

    @contextlib.contextmanager
    def installed(self):
        from herdsman_tpu_torch.ops import bootstrap as bs
        from herdsman_tpu_torch.ops.kernels import _build, mega13

        originals = {(_build, "load"): _build.load,
                     (bs, "blind_rotate_batch"): bs.blind_rotate_batch,
                     (bs, "rotation_inputs"): bs.rotation_inputs,
                     (bs, "key_switch_batch"): bs.key_switch_batch,
                     (mega13, "int8_matmul"): mega13.int8_matmul}
        load, rotate, inputs = (_build.load, bs.blind_rotate_batch,
                                bs.rotation_inputs)
        key_switch, int8_matmul = bs.key_switch_batch, mega13.int8_matmul

        def timed_load(name):
            t0 = time.perf_counter()
            lib = load(name)
            self.loads.append((name, time.perf_counter() - t0))
            return lib

        def timed_rotate(*args, **kwargs):
            loaded = sum(s for _, s in self.loads)
            n_inputs = len(self.inputs)
            out, host, dev_ms = self._timed(rotate, *args, **kwargs)
            self.rotations.append(
                (host - (sum(s for _, s in self.loads) - loaded), dev_ms,
                 sum(self.inputs[n_inputs:])))
            return out

        def timed_inputs(*args, **kwargs):
            out, host, _ = self._timed(inputs, *args, **kwargs)
            self.inputs.append(host)
            return out

        def timed_key_switch(*args, **kwargs):
            self._in_key_switch += 1
            try:
                return key_switch(*args, **kwargs)
            finally:
                self._in_key_switch -= 1

        def timed_int8_matmul(*args, **kwargs):
            if not self._in_key_switch:
                return int8_matmul(*args, **kwargs)
            out, host, dev_ms = self._timed(int8_matmul, *args, **kwargs)
            self.int_mms.append((host, dev_ms))
            return out

        for (mod, attr), fn in zip(originals, (
                timed_load, timed_rotate, timed_inputs, timed_key_switch,
                timed_int8_matmul)):
            setattr(mod, attr, fn)
        try:
            yield self
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)

    def mark(self) -> tuple[int, int, int]:
        return len(self.loads), len(self.rotations), len(self.int_mms)


def map_circuit():
    """The coordinator's test job's map: x = a XOR b, odd = parity(x)."""
    from herdsman_tpu_torch.circuit import (CircuitBuilder, ColumnMeta,
                                            DataType)

    mb = CircuitBuilder((ColumnMeta("a", DataType.UINT8),
                         ColumnMeta("b", DataType.UINT8)))
    x = mb.input_column("a") ^ mb.input_column("b")
    parity = x.bits[0]
    for bit in x.bits[1:]:
        parity = parity ^ bit
    mb.output("x", x)
    mb.output("odd", parity)
    return mb.build()


def probe(key_path: str, engine: str = "mega13", batch: int = 512,
          device: str = "cuda", seed: int = 0, layouts_file: str = "",
          out=None) -> dict[str, float]:
    """Run the phases (module docstring) and return their seconds by the
    names of ``PHASES`` (with an existing ``layouts_file``, "device layouts
    from the file" in place of "device_server_key"), printing a line for
    each to ``out`` (``sys.stdout`` by default)."""
    out = out or sys.stdout
    secs: dict[str, float] = {}
    notes: dict[str, str] = {}
    last = T0  # the end of the previous phase

    def phase(name: str, note: str = "") -> None:
        nonlocal last
        now = time.perf_counter()
        secs[name] = now - last
        last = now
        notes[name] = note
        print(f"[{now - T0:8.3f} s] {name}: {secs[name]:.3f} s"
              + (f" ({note})" if note else ""), file=out, flush=True)

    import numpy as np
    import torch
    phase("import torch", f"torch {torch.__version__}")

    from herdsman_tpu_torch.compiler.lower import compile_circuit
    from herdsman_tpu_torch.ops.server_key import (DeviceServerKey,
                                                   device_server_key,
                                                   fit_engine,
                                                   layouts_for_engine)
    from herdsman_tpu_torch.ops.u32 import resolve_device, to_numpy_u32
    from herdsman_tpu_torch.service import offload_worker  # noqa: F401
    from herdsman_tpu_torch.service.config import port_engine
    from herdsman_tpu_torch.service.coordinator import deserialize_server_key
    phase("import the port's service modules")

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        phase("CUDA context", torch.cuda.get_device_name(dev))
    else:
        phase("CUDA context", "none: on the CPU")

    with open(key_path, "rb") as f:
        data = f.read()
    phase("read the key file", f"{len(data) / 2**20:.1f} MiB")
    sk = deserialize_server_key(data)
    del data
    phase("deserialize_server_key", sk.params.name)

    eng = fit_engine(port_engine(engine), sk.params)
    layouts = layouts_for_engine(eng)
    probed = _Probe(torch, dev)
    saved = pathlib.Path(layouts_file) if layouts_file else None
    if saved is not None and saved.exists():
        dsk = DeviceServerKey(params=sk.params, device=dev, **torch.load(
            saved, map_location=dev, weights_only=True))
        probed.sync()
        phase("device layouts from the file",
              f"engine {eng}, {saved.stat().st_size / 2**30:.3f} GiB")
    else:
        dsk = device_server_key(sk, layouts=layouts, device=dev)
        probed.sync()
        phase("device_server_key", f"engine {eng}, layouts {layouts}")

    circuit = map_circuit()
    fn = compile_circuit(circuit, dsk, engine=eng, device=dev)
    phase("compile_circuit", f"{len(circuit.gates)} gates")

    p = sk.params
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (batch, circuit.num_input_bits, p.n + 1),
                        dtype=np.uint64).astype(np.uint32)
    last = time.perf_counter()
    outs = []
    with probed.installed():
        for call in ("first call", "second call"):
            n_load, n_rot, n_mm = probed.mark()
            outs.append(to_numpy_u32(fn(rows)))
            phase(call, f"{batch} rows, "
                  f"{len(probed.rotations) - n_rot} rotations")
            loads = probed.loads[n_load:]
            rot_s, rot_ms, inputs_s = probed.rotations[n_rot]
            mm_s, mm_ms = probed.int_mms[n_mm]
            split = {"first rotation": (rot_s, rot_ms),
                     "first key switch's torch._int_mm": (mm_s, mm_ms)}
            if call == "first call":
                secs[f"{call}: _build.load"] = sum(s for _, s in loads)
                notes[f"{call}: _build.load"] = ", ".join(
                    f"{name} {s:.3f} s" for name, s in loads) or "none"
            for name, (s, ms) in split.items():
                secs[f"{call}: {name}"] = s
                notes[f"{call}: {name}"] = ("host" if ms is None else
                                            f"host; CUDA events {ms:.3f} ms")
            notes[f"{call}: first rotation"] += (
                f"; of the host time, rotation_inputs {inputs_s:.3f} s")
            secs[f"{call}: the rest"] = secs[call] - sum(
                secs[k] for k in secs if k.startswith(f"{call}: "))
            notes[f"{call}: the rest"] = ""
            for name in PHASES:
                if name.startswith(f"{call}: "):
                    print(f"    {name}: {secs[name]:.3f} s"
                          + (f" ({notes[name]})" if notes[name] else ""),
                          file=out, flush=True)
            last = time.perf_counter()
    if not np.array_equal(outs[0], outs[1]):
        raise RuntimeError("the second call's output differs from the "
                           "first's")
    if saved is not None and not saved.exists():
        t0 = time.perf_counter()
        torch.save({f.name: getattr(dsk, f.name)
                    for f in dataclasses.fields(dsk)
                    if isinstance(getattr(dsk, f.name), torch.Tensor)},
                   saved)
        print(f"saved the device key's tensors to {saved} "
              f"({saved.stat().st_size / 2**30:.3f} GiB) in "
              f"{time.perf_counter() - t0:.3f} s", file=out, flush=True)
    print(json.dumps({"probe_coldstart": {
        "engine": eng, "batch": batch, "device": str(dev),
        "seconds": secs}}), file=out, flush=True)
    return secs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--key", required=True,
                    help="a server key file (serialize_server_key's bytes)")
    ap.add_argument("--engine", default="mega13",
                    help="a port engine or a config's engine name")
    ap.add_argument("--batch", type=int, default=512,
                    help="rows of the map task")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--layouts-file", default="",
                    help="save the device key's tensors here, or load them "
                         "from here where the file exists")
    args = ap.parse_args(argv)
    probe(args.key, args.engine, args.batch, args.device, args.seed,
          args.layouts_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
