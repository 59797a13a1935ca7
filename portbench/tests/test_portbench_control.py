"""The control: the reference put in the program's place one precision
below the configuration's (bfloat16 for float32) fails the cell's
limits, while the program meets them, on the same requests (the tiny
cells; `portbench/control.py` reads both at the cells' own sizes on the
card)."""
import contextlib
import io
import json
import os

from portbench import control


def readings(root, cell, seeds):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = control.main(["--root", root, "--workload", cell, "--seeds",
                           *map(str, seeds), "--program", "--device",
                           "cpu"])
    assert rc == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_the_control_fails_and_the_program_passes(tiny_root, one_thread):
    cell = "tiny.table"
    with open(os.path.join(tiny_root, "portbench", "limits",
                           cell + ".json")) as f:
        limits = json.load(f)
    for line in readings(tiny_root, cell, [2**31 + 7, 11, 12]):
        assert line["match_km"] < 1e-6
        assert any(line["control"][k] > v for k, v in limits.items())
        assert all(line["program"][k] <= v for k, v in limits.items())
