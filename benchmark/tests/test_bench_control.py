"""The control: the reference in the program's place, computed with TF32
operands (the precision below the float32 the configuration states, with
TF32 off), comes out not correct; on the CPU at a tiny size, and on the
card at the cells' own sizes."""

import pytest
import torch

import run
from harness import serve
from harness.spec import HERE, load_cell, load_json
from tiny import tiny_cell

B = load_json(HERE.parent / "BENCHMARK.json")


def _control(monkeypatch):
    """The program's calls answered by the TF32 reference, free-running."""
    made = {}
    plain_init = serve.Server.__init__

    def init(self, config, weights, device):
        plain_init(self, config, weights, device)
        cell_ref = load_cell(B, "codes_b1").reference()
        made["ref"] = cell_ref.make(weights, self.hp.values(), tf32=True)

    def call(self, req, spans):
        source = torch.from_numpy(req.source).to(self.device)
        logits, stop = made["ref"]([source], self.hp.max_iters,
                                   [req.speaker])
        return dict(steps=self.hp.max_iters, logits=logits[0].cpu(),
                    stop=stop[0].cpu())

    monkeypatch.setattr(serve.Server, "__init__", init)
    monkeypatch.setattr(serve.Server, "__call__", call)


@pytest.mark.parametrize("speakers", [False, True],
                         ids=["codes", "speakers"])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct_tiny(monkeypatch, speakers, seed):
    cell = tiny_cell(speakers,
                     limits=load_cell(B, "codes_b1").params["limits"])
    _control(monkeypatch)
    result = run.execute(cell, seed, 0.2, False, torch.device("cpu"),
                         log=lambda *a, **k: None)
    assert not result["correct"], result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", [w["name"] for w in B["workloads"]])
def test_control_is_not_correct_on_the_card(monkeypatch, card, cell_name):
    _control(monkeypatch)
    cell = load_cell(B, cell_name)
    for seed in (1, 2, 3):
        result = run.execute(cell, seed, 1.0, False, card,
                             log=lambda *a, **k: None)
        assert not result["correct"], result["checks"]
