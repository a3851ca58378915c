"""The port's decoding and serving examples on the CPU, each to its JAX
counterpart's assertions (they raise inside ``main`` otherwise):
``lm_generate`` (greedy and beam continuations follow the learned rule on
more than 80% of tokens, sampled ones on more than 50%, the eos row
flatlines), ``swa_gqa_lm`` (RoPE, window 8, 2 kv heads: decoded
continuations over 80%) and ``continuous_serving`` (24 requests over 2
replicas x 4 slots, every stream token-exact against offline
``generate``).  The two training examples run 100 Adam steps here, where
their loss is already below 0.01, instead of their default 250.  The
mesh-parallel ones: ``parallel_serving`` (dense == TP == PP greedy, EOS
freeze, TP beam(1) == greedy, beam 3; rank-major on 4 and 8 ranks and a
world of one) and ``moe_generate`` (the EP MoE LM trained rank-major on
dcn 2 x ici 2, decoded by ``generate_parallel`` and 3-beam
``beam_search_parallel``: a short run here, JAX's full 150 steps to its
0.8 rule bar under ``-m slow``)."""

import importlib

import pytest
import torch

import torchmpi_tpu_torch as tmpi

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def no_runtime():
    """Each example starts and stops its own runtime."""
    tmpi.stop()
    yield
    tmpi.stop()


def _main(name, argv):
    mod = importlib.import_module(f"torchmpi_tpu_torch.examples.{name}")
    return mod.main(["--device", "cpu"] + argv)


@pytest.mark.parametrize("name", ["lm_generate", "swa_gqa_lm"])
def test_decode_example_reaches_the_rule(name):
    out = _main(name, ["--steps", "100"])
    assert out["greedy"] > 0.8
    assert out["losses"][-1] < 0.05 * out["losses"][0]
    if name == "lm_generate":
        assert out["beam"] > 0.8 and out["sampled"] > 0.5
    assert not tmpi.is_initialized()


def test_continuous_serving_example_token_exact():
    out = _main("continuous_serving", [])
    assert out["tokens"] > 0 and set(out["replicas"]) == {"replica0",
                                                          "replica1"}


@pytest.mark.parametrize("argv", [["--devices", "4"], ["--devices", "8"],
                                  []], ids=["rank-major-4", "rank-major-8",
                                            "world-of-one"])
def test_parallel_serving_example_agrees(argv):
    out = _main("parallel_serving", argv)
    assert out["ranks"] == (int(argv[1]) if argv else 1)
    assert out["tokens"].shape == (8, 12) and out["beam3"].shape == (8, 12)


def test_moe_generate_example_runs():
    out = _main("moe_generate", ["--devices", "4", "--dcn", "2",
                                 "--steps", "3"])
    assert out["tokens"].shape == (4, 12)
    assert 0.0 <= out["greedy"] <= 1.0 and 0.0 <= out["beam"] <= 1.0


@pytest.mark.slow
def test_moe_generate_example_follows_the_rule():
    out = _main("moe_generate", ["--devices", "4", "--dcn", "2"])
    assert out["greedy"] > 0.8 and out["beam"] > 0.8
