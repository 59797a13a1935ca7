"""A run with the timed path broken underneath comes out not correct:
a solve step that returns its state unchanged, half of a
batch left out (its rows copied from the other half), and an answer
altered where it is produced; a sound run comes out correct.  The runs
skip the harness's look for a card and run the kernels' plain versions
on the CPU at the tiny sizes (tiny.py); the cells have no exchange
between chips to leave out."""
import numpy as np
import pytest

from portbench import harness

SEED = 2**31 + 4242


def unchanged(mp):
    import raytracer_tpu_torch.ops.sweep_theta as st

    mp.setattr(st, "rsweep", lambda buf, *a, **k: buf)


def _half(sources):
    s = np.asarray(sources)
    h = (len(s) + 1) // 2
    return np.concatenate([s[:h], s[:h]])[:len(s)]


def half_batch(mp):
    from raytracer_tpu_torch.solvers import api

    table = api.AnnulusSolver.travel_time_table
    mp.setattr(api.AnnulusSolver, "travel_time_table",
               lambda self, sources, receivers, batch=8:
               table(self, _half(sources), receivers, batch))


def altered(mp):
    from raytracer_tpu_torch.solvers import api

    table = api.AnnulusSolver.travel_time_table

    def table2(self, *a, **k):
        t = table(self, *a, **k)
        t[:, -1] += 10.0
        return t

    mp.setattr(api.AnnulusSolver, "travel_time_table", table2)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered": altered}


def run(root, cell):
    return harness.run_cell(root, cell, SEED, 0.3, 0, device="cpu")


def test_a_sound_run_is_correct(tiny_root, one_thread):
    r = run(tiny_root, "tiny.table")
    assert r["correct"], r["checks"]
    assert r["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_path_is_not_correct(tiny_root, one_thread, monkeypatch,
                                      fault):
    FAULTS[fault](monkeypatch)
    r = run(tiny_root, "tiny.table")
    assert not r["correct"], r["checks"]
