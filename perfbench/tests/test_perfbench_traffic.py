"""The traffic generator repeats by seed and is read from data alone."""
import numpy as np
import pytest

from perfbench import spec, traffic

MIXES = ["surveillance_peak", "hd_trickle"]
BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("name", MIXES)
@pytest.mark.parametrize("seed", [0, 7, BIG, 2 ** 40 + 3])
def test_episode_repeats_by_seed(name, seed):
    mix = spec.traffic(name)
    a, b = traffic.episode(mix, seed, 3), traffic.episode(mix, seed, 3)
    assert a == b
    assert len(a["arrivals"]) == mix["episode_frames"]
    assert np.all(np.diff(a["arrivals"]) > 0)
    assert set(a["cls"]) <= set(range(len(mix["classes"])))
    assert max(a["image"]) < mix["images_per_class"]
    assert a["origin"][:4] == [0, 1, 2, 0]


@pytest.mark.parametrize("name", MIXES)
def test_episodes_differ_and_seeds_pick_the_frames(name):
    mix = spec.traffic(name)
    e = {(s, k): traffic.episode(mix, s, k) for s in (BIG, BIG + 1) for k in (0, 1)}
    assert e[BIG, 0]["arrivals"] != e[BIG, 1]["arrivals"]
    assert e[BIG, 0]["arrivals"] == e[BIG + 1, 0]["arrivals"]
    assert e[BIG, 0]["cls"] == e[BIG + 1, 0]["cls"]
    assert e[BIG, 0]["rng_seed"] == e[BIG + 1, 0]["rng_seed"]
    assert e[BIG, 0]["image"] != e[BIG + 1, 0]["image"]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_has_the_same_work(name):
    """The same gaps and class counts in every episode, in another order,
    and the same streams for every seed."""
    mix = spec.traffic(name)
    eps = [traffic.episode(mix, s, k) for s in (1, BIG) for k in (0, 5)]
    gaps = [np.sort(np.diff([0.0] + e["arrivals"])) for e in eps]
    counts = [np.bincount(e["cls"], minlength=len(mix["classes"])) for e in eps]
    for g, c in zip(gaps[1:], counts[1:]):
        assert np.allclose(g, gaps[0], rtol=1e-12) and np.array_equal(c, counts[0])
    assert gaps[0].mean() == pytest.approx(mix["inter_arrival"], rel=1e-12)
    assert eps[0]["cls"] != eps[1]["cls"] or len(mix["classes"]) == 1


def test_peak_mix_shares():
    mix = spec.traffic("surveillance_peak")
    assert list(traffic.class_counts([0.2, 0.3, 0.5], 512)) == [102, 154, 256]
    assert list(traffic.class_counts([1.0], 512)) == [512]
    g = traffic.quantile_gaps(512, mix["inter_arrival"])
    # an exponential's spread: the median gap ln 2 of the mean
    assert np.median(g) == pytest.approx(mix["inter_arrival"] * np.log(2),
                                         rel=0.02)
    # the stream's mean gap 1.2 at the diurnal intensity's peak and trough
    # (1 +- amplitude 0.8)
    assert mix["inter_arrival"] == pytest.approx(1.2 / 1.8, rel=1e-12)
    assert spec.traffic("hd_trickle")["inter_arrival"] == \
        pytest.approx(1.2 / 0.2, rel=1e-12)


def test_batch_times():
    mix = spec.traffic("surveillance_peak")
    t = traffic.batch_times(mix["classes"][0], mix["batch_model"])
    assert t == {1: 18.0, 2: 18.0 * 1.15, 4: 18.0 * 1.45, 8: 18.0 * 2.05}
    assert traffic.resolutions(mix) == [384, 224]
