"""The comparison has to fail a broken program: each fault a training cell
can have, planted in the program underneath a whole run at a smoke size on
the CPU, makes ``correct`` come out false.

* a step that returns its state unchanged;
* half of the batch left out, the mean taken over the rest;
* an answer altered where it is produced: the first server step's update
  of its largest-moving leaf doubled;
* the L-BFGS ring index that stops at its last slot once the history is
  full, so the newest pair overwrites the one before it and the oldest is
  never dropped (a fault of the wrapped history, which only steps past
  m + 1 reach).

(The exchange between chips has no place in a one-chip cell.)
"""
from __future__ import annotations

import pytest
from test_feelbench_rehearsal import run


def _double_first_update(monkeypatch):
    import torch

    from repro_torch.core import fim_lbfgs
    from repro_torch.utils.pytree import tree_leaves, tree_map

    orig = fim_lbfgs.update
    calls = []

    def update(state, params, *args, **kwargs):
        new_params, new_state, stats = orig(state, params, *args, **kwargs)
        if not calls:
            moves = [torch.linalg.vector_norm((a - b).float())
                     for a, b in zip(tree_leaves(new_params), tree_leaves(params))]
            top = max(range(len(moves)), key=lambda i: float(moves[i]))
            at = iter(range(len(moves)))
            new_params = tree_map(lambda a, b: 2 * a - b if next(at) == top else a,
                                  new_params, params)
        calls.append(1)
        return new_params, new_state, stats

    monkeypatch.setattr(fim_lbfgs, "update", update)


def _lm_state_unchanged(monkeypatch):
    from repro_torch.launch import train

    orig = train.make_train_step

    def make(*args, **kwargs):
        step = orig(*args, **kwargs)

        def unchanged(params, opt_state, batch):
            _, _, stats = step(params, train.fim_lbfgs.init(params, args[1]), batch)
            return params, opt_state, stats
        return unchanged

    monkeypatch.setattr(train, "make_train_step", make)


def _lm_half_batch(monkeypatch):
    from repro_torch.launch import train

    orig = train._OneDevice.cohorts

    def cohorts(self, batch, n_micro):
        micro, nm = orig(self, batch, n_micro)
        half = max(1, nm // 2)
        return {k: v[:half] for k, v in micro.items()}, half

    monkeypatch.setattr(train._OneDevice, "cohorts", cohorts)


def _ring_stops_at_the_end(monkeypatch):
    import torch

    from repro_torch.core import lbfgs

    orig = lbfgs.push_

    def push_(h, s, y, ok):
        out = orig(h, s, y, ok)
        m = lbfgs.tree_leaves(h.s)[0].shape[0]
        return out._replace(idx=torch.clamp_max(h.idx + ok.to(h.idx.dtype), m - 1))

    monkeypatch.setattr(lbfgs, "push_", push_)


LM_FAULTS = [_lm_state_unchanged, _lm_half_batch, _double_first_update,
             _ring_stops_at_the_end]
FAULTS = {"granite_train.s512": LM_FAULTS, "granite_train.s4096": LM_FAULTS}


@pytest.mark.parametrize("cell, fault", [(c, f) for c, fs in FAULTS.items() for f in fs],
                         ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_fault_fails_the_run(smoke_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    result, err = run(smoke_root, cell, False, seed=2**31 + 77)
    assert not result["correct"], err
