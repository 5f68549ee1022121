"""The timed path broken underneath: a whole run on the CPU at smoke size
(the harness's look for a card skipped) sees ``correct`` come out false
for each fault a cell can have.  A cell runs on one card, so it has no
exchange between cards to leave out."""
import pytest
import torch

from bench import smoke

FAULTS = [("mamba2-2.7b.train", "unchanged"),
          ("mamba2-2.7b.train", "half_batch"),
          ("deepseek-moe-16b.train", "unchanged"),
          ("deepseek-moe-16b.train", "half_batch"),
          ("mamba2-2.7b.prefill", "token"),
          ("mamba2-2.7b.prefill", "long_logits"),
          ("deepseek-moe-16b.prefill", "token"),
          ("deepseek-moe-16b.prefill", "long_logits")]


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_makes_the_run_incorrect(cell, fault):
    _, out = smoke.run(cell, fault=fault)
    assert out["correct"] is False, out["checks"]
    failing = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failing


def test_a_fault_in_the_longest_prompts_alone_is_seen():
    """The longest prompts' logits wrong and their tokens right: the
    median within each length sees it, where the median over every checked
    request, most of them shorter, would not."""
    r, out = smoke.run("deepseek-moe-16b.prefill", fault="long_logits")
    c = out["checks"]
    assert c["token_gap"]["value"] <= c["token_gap"]["limit"]
    lim = c["logit_err_len_median"]["limit"]
    assert c["logit_err_len_median"]["value"] > lim
    assert r.info["logit_err_quantiles"][2] < lim
