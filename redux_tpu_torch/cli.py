"""Command line of the PyTorch port::

    python -m redux_tpu_torch.cli (-c | -d) [-i <input file>] [-o <output file>]
        [--format rxt|redux|auto] [--block-size N] [--params S,F,C] [--no-prior]
        [--device cuda|cpu]

Counterpart: ``redux_tpu/cli.py``, the same flags, output bytes, stderr
lines and exit codes:

* ``-c`` compress / ``-d`` decompress, exactly one required;
* stdin/stdout when ``-i``/``-o`` are left out;
* the ratio line on stderr;
* exit codes 1 = usage, 2 = file open, 3 = codec error.

``--format`` picks the block archive (``rxt``, the default), the
reference's bare stream (``redux``, byte-identical to the reference CLI
at its ``Parameters(8, 30, 32)``) or the smallest candidate (``auto``);
``--block-size`` sets the symbols per block, ``--params`` the arithmetic
parameters (default ``Parameters.default()``, (8,30,32)), ``--no-prior``
turns the warm-start prior off.  Decompression tells the formats apart
itself.

``--device`` (default ``cuda``) is where the block archive's kernels run,
the counterpart of how the reference picks its backend.  ``cpu`` runs
their plain versions.  ``--format redux`` and the compact archives are
host code on either.  With ``cuda`` and no card the command exits 3; it
does not run on the CPU instead, and a native library that cannot be
built exits 3 too (no fallback to the Python oracle).
"""

from __future__ import annotations

import sys

USAGE = (
    "Usage: redux-tpu (-c | -d) [-i <input file>] [-o <output file>] [--format rxt|redux|auto] "
    "[--block-size N] [--params S,F,C] [--no-prior] [--device cuda|cpu]"
)


def _parse_args(argv):
    opts = {
        "compress": None,
        "input": None,
        "output": None,
        "format": "rxt",
        "block_size": None,
        "params": None,
        "prior": True,
        "device": "cuda",
    }
    it = iter(argv)
    for arg in it:
        if arg == "-c":
            opts["compress"] = True
        elif arg == "-d":
            opts["compress"] = False
        elif arg == "-i":
            opts["input"] = next(it, None)
            if opts["input"] is None:
                return None
        elif arg == "-o":
            opts["output"] = next(it, None)
            if opts["output"] is None:
                return None
        elif arg == "--format":
            fmt = next(it, None)
            if fmt not in ("rxt", "redux", "auto"):
                return None
            opts["format"] = fmt
        elif arg == "--block-size":
            val = next(it, None)
            if val is None or not val.isdigit() or int(val) < 1:
                return None
            opts["block_size"] = int(val)
        elif arg == "--params":
            val = next(it, None)
            try:
                s, f, c = (int(x) for x in val.split(","))
            except (AttributeError, ValueError):
                return None
            opts["params"] = (s, f, c)
        elif arg == "--no-prior":
            opts["prior"] = False
        elif arg == "--device":
            dev = next(it, None)
            if dev not in ("cuda", "cpu"):
                return None
            opts["device"] = dev
        else:
            return None
    if opts["compress"] is None:  # the mode flag is mandatory
        return None
    return opts


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = _parse_args(argv)
    if opts is None:
        print(USAGE, file=sys.stderr)
        return 1

    # Late imports keep usage errors fast.
    from .errors import ReduxError
    from .params import Parameters

    try:
        params = (
            Parameters(*opts["params"]) if opts["params"] else Parameters.default()
        )
    except ReduxError as e:
        print(f"Invalid parameters: {e}", file=sys.stderr)
        return 1

    if opts["input"] is None:
        data = sys.stdin.buffer.read()
    else:
        try:
            with open(opts["input"], "rb") as f:
                data = f.read()
        except OSError as e:
            print(f"Error while opening input file {opts['input']}: {e}", file=sys.stderr)
            return 2

    from . import api, native

    device = opts["device"]
    try:
        if opts["compress"]:
            if opts["format"] == "redux":
                out = native.compress_bytes(data, params)
            elif opts["format"] == "auto":
                out = api.encode_auto(
                    data,
                    params=params,
                    **({"block_size": opts["block_size"]} if opts["block_size"] else {}),
                    device=device,
                )
            else:
                kwargs = {}
                if opts["block_size"] is not None:
                    kwargs["block_size"] = opts["block_size"]
                if not opts["prior"]:
                    kwargs["use_prior"] = False
                out = api.encode(data, params=params, device=device, **kwargs)
            msg = (
                f"Compressed {len(data)} bytes into {len(out)} bytes, "
                f"ratio: {len(data) / len(out):.3f}"
                if out
                else "Compressed 0 bytes"
            )
        else:
            out = api.decode_auto(data, params=params, device=device)
            msg = (
                f"Decompressed {len(out)} bytes from {len(data)} bytes, "
                f"ratio: {len(out) / len(data):.3f}"
                if data
                else "Decompressed 0 bytes"
            )
    except (ReduxError, RuntimeError) as e:
        # RuntimeError: no CUDA device for --device cuda, or a native
        # library that cannot be built.
        mode = "Compression" if opts["compress"] else "Decompression"
        print(f"{mode} error: {e}", file=sys.stderr)
        return 3

    if opts["output"] is None:
        sys.stdout.buffer.write(out)
        sys.stdout.buffer.flush()
    else:
        try:
            with open(opts["output"], "wb") as f:
                f.write(out)
        except OSError as e:
            print(f"Error while opening output file {opts['output']}: {e}", file=sys.stderr)
            return 2

    print(msg, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
