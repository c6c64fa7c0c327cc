"""The seeded traffic generator."""
import itertools
import math

import pytest

from synbench.core import spec, traffic

MIXES = ["emulate_prompts", "emulate_decode", "serve_prefill"]


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


def test_groups_arrive_whole():
    mix = _mix("serve_prefill")
    groups = [sorted(g) for g in traffic.cycle(mix)]
    got = _take(mix, 11, 2 * mix["cycle"])
    for _, members in itertools.groupby(got, key=lambda r: r[2]):
        assert sorted((p, o) for p, o, _ in members) in groups


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
