"""The seeded traffic generator."""
import itertools
import math

import pytest

from synbench.core import spec, traffic

MIXES = ["emulate_prompts", "emulate_decode", "serve_prefill",
         "serve_prefill_pool"]


def _mix(name):
    return spec.load_json(f"{spec.HERE}/traffic/{name}.json")


def _take(mix, seed, n):
    return [(r.prompt, r.output, r.group)
            for r in itertools.islice(traffic.stream(mix, seed), n)]


@pytest.mark.parametrize("name", MIXES)
def test_repeats_by_seed_and_differs_across_seeds(name):
    mix = _mix(name)
    n = 3 * mix["cycle"]
    big = 2 ** 33 + 17                      # beyond 32 signed bits
    assert _take(mix, big, n) == _take(mix, big, n)
    assert _take(mix, big, n) != _take(mix, big + 1, n)


@pytest.mark.parametrize("name", MIXES)
def test_every_cycle_holds_the_same_requests(name):
    mix = _mix(name)
    n = mix["cycle"]
    want = sorted(r for g in traffic.cycle(mix) for r in g)
    for seed in (0, 5, 2 ** 31 + 3):
        got = _take(mix, seed, 4 * n)
        for c in range(4):
            assert sorted((p, o) for p, o, _ in got[c * n:(c + 1) * n]) \
                == want


@pytest.mark.parametrize("name", ["serve_prefill", "serve_prefill_pool"])
def test_groups_arrive_whole(name):
    mix = _mix(name)
    groups = [sorted(g) for g in traffic.cycle(mix)]
    got = _take(mix, 11, 2 * mix["cycle"])
    for _, members in itertools.groupby(got, key=lambda r: r[2]):
        assert sorted((p, o) for p, o, _ in members) in groups


def test_the_pool_holds_the_mix_of_serve_prefill_in_waves_of_its_slots():
    """The pool's prompts are ``serve_prefill``'s distribution: its cycle
    is 120 quantiles of the same log-uniform 1024-4096, rounded to 128,
    in three waves of 40 (the engine's slots), one token each."""
    pool, mix = _mix("serve_prefill_pool"), _mix("serve_prefill")
    assert pool["prompt"] == mix["prompt"] and pool["output"] == mix["output"]
    groups = traffic.cycle(pool)
    assert [len(g) for g in groups] == [pool["batch_slots"]] * 3
    lens = sorted(p for g in groups for p, _ in g)
    assert lens[0] == 1152 and lens[-1] == 4096      # 1030 rounded up
    assert all(p % 128 == 0 for p in lens)
    # padded to each wave's longest, 43.66% of the positions are padding
    pad = 1 - sum(lens) / sum(len(g) * max(p for p, _ in g) for g in groups)
    assert round(100 * pad, 2) == 43.66


def test_quantiles_hand_worked():
    mix = {"cycle": 4, "prompt": {"dist": "loguniform", "min": 1, "max": 16},
           "output": {"dist": "fixed", "value": 3}}
    # quantiles 1/8, 3/8, 5/8, 7/8 of log-uniform(1, 16): 16 ** q
    want = sorted(math.ceil(round(16 ** ((i + 0.5) / 4), 6))
                  for i in range(4))
    assert sorted(p for g in traffic.cycle(mix) for p, _ in g) == want
    assert want == [2, 3, 6, 12]
    mix["prompt"]["round_up"] = 4
    assert sorted(p for g in traffic.cycle(mix) for p, _ in g) == \
        [4, 4, 8, 12]


def test_token_ids_repeat_and_stay_in_range():
    a = traffic.token_ids(2 ** 32 + 1, 5, 100, 152064)
    assert (a == traffic.token_ids(2 ** 32 + 1, 5, 100, 152064)).all()
    assert (a != traffic.token_ids(2 ** 32 + 1, 6, 100, 152064)).any()
    assert a.min() >= 0 and a.max() < 152064
