"""The draw of the answers judged (``loops.solve.is_judged``): one in each
block of ``1 / check_share`` consecutive requests, picked by the run's
seed, so every run keeps the same number of answers whatever its seed."""
import math
import re

import pytest

import _small
from msfbench.loops.solve import block_size, is_judged

SHARE = 0.25
SEEDS = [_small.SEED, 0, 1, 12, -7, 2**63 + 5] + [3_131_000_011 * i for i in range(1, 15)]
N = 200


def flags(seed, n=N, share=SHARE):
    return [is_judged(seed, share, k) for k in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_prefix_judges_a_quarter(seed):
    f = flags(seed)
    for n in range(1, N + 1):
        assert sum(f[:n]) in (n // 4, math.ceil(n / 4)), n


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("share", [0.25, 0.5, 0.125, 1.0])
def test_one_judged_in_every_full_block(seed, share):
    b = block_size(share)
    f = flags(seed, share=share)
    for j in range(N // b):
        assert sum(f[j * b:(j + 1) * b]) == 1, j


@pytest.mark.parametrize("seed", SEEDS)
def test_the_same_seed_gives_the_same_flags(seed):
    # drawn in any order: a flag depends on the seed and the request alone
    backwards = [is_judged(seed, SHARE, k) for k in reversed(range(N))][::-1]
    assert flags(seed) == backwards


@pytest.mark.parametrize("a, b", list(zip(SEEDS, SEEDS[1:])))
def test_two_seeds_give_different_flags(a, b):
    assert flags(a) != flags(b)


def test_every_position_is_drawn():
    counts = [0] * 4
    for seed in SEEDS:
        for k, judged in enumerate(flags(seed)):
            counts[k % 4] += judged
    total = len(SEEDS) * N // 4
    # each position close to a quarter of the blocks
    assert all(0.2 * total <= c <= 0.3 * total for c in counts), counts


@pytest.mark.parametrize("share", [0.3, 0.0, -0.25, 1.5, 2.0, 0.26])
def test_a_share_whose_inverse_is_not_whole_raises(share):
    with pytest.raises(ValueError):
        block_size(share)
    with pytest.raises(ValueError):
        is_judged(_small.SEED, share, 0)


def test_the_loop_refuses_such_a_share_before_set_up():
    built = []

    class Records:
        def __init__(self, device, spec=None):
            built.append(spec)

    cell = _small.CELLS[0]
    traffic = dict(_small.small_traffic(cell), check_share=0.3)
    with pytest.raises(ValueError):
        _small.harness.run_cell(cell, seed=_small.SEED, seconds=0.2, trace=False,
                                device="cpu", t_process=0.0, bench=_small.BENCH,
                                config=_small.small_config(cell), traffic=traffic,
                                system=Records)
    assert built == []


@pytest.mark.parametrize("cell", _small.CELLS)
@pytest.mark.parametrize("seed", [_small.SEED, 12])
def test_a_small_cell_judges_the_drawn_answers_and_the_last(cell, seed, capsys):
    """A run judges the answers its seed draws, a quarter to one, and the
    last answer of every graph of the pool."""
    result, _ = _small.run(cell, seed=seed, seconds=2.0)
    assert result["correct"] and result["failed"] == 0
    n = result["attempted"]
    share = _small.small_traffic(cell)["check_share"]
    pool = _small.small_traffic(cell)["pool"]
    drawn = {k for k in range(n) if is_judged(seed, share, k)}
    assert len(drawn) in (n // 4, math.ceil(n / 4))
    last = {max(k for k in range(n) if k % pool == i) for i in range(min(pool, n))}
    said = re.findall(r"answers judged: (\d+) of (\d+)", capsys.readouterr().err)
    assert said == [(str(len(drawn | last)), str(n))]
