"""tools/ablate_enhanced.py on a machine without a card: its arguments are
checked, and it raises, naming the missing CUDA card, instead of timing
anything on the CPU. Its variants run only on the card
(tests/test_torch_kernels.py::test_ablation_variants_launch)."""

import pytest
import torch

from chessboard_vision_tpu_torch.tools import ablate_enhanced as ab


@pytest.mark.parametrize("text,want", [("980", (980, 980)), ("1080x1920", (1080, 1920)),
                                       ("720X1280", (720, 1280))])
def test_size_forms(text, want):
    assert ab.parse_args(["--size", text]).size == want


@pytest.mark.parametrize("argv", [["--size", "big"], ["--size", "8"], ["--size", "1x2x3"],
                                  ["--only", "bilateral,fft"], ["--iters", "0"],
                                  ["--passes", "0"]])
def test_bad_arguments_exit(argv):
    with pytest.raises(SystemExit):
        ab.parse_args(argv)


def test_groups_default_and_only():
    assert ab.parse_args([]).groups == list(ab.GROUPS)
    assert ab.parse_args(["--only", "hist,empty"]).groups == ["hist", "empty"]


def test_no_card_raises_naming_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        ab.main(["--only", "empty"])
