"""The counter-hash sampler's kernel wrappers (``ops/counter_normal.py``) on
the CPU, where they take their plain versions: the draws and folds that
``prob/distributions.py`` hands out through them are exactly what the
sampler's composition gave before the kernels (the words of ``_site_word``
and the folds worked out on Python ints here, Box-Muller in float64 tensors
as ``standard_normal_ps`` composed it), for int seeds, 0-d and ``(S,)``
seed tensors, 0-d seeds under ``torch.func.vmap``, sample ids ``(B,)`` and
``(S, B)``, odd and even event sizes, and one and two fold words applied to
a seed tensor before the draw. The kernels themselves run on the card
(``tests/test_torch_gpu.py``, ``-k counter_normal``)."""

import math
import os
import re
import zlib

import pytest
import torch

from structured_latent_odes_tpu_torch.ops import counter_normal as cn
from structured_latent_odes_tpu_torch.prob import distributions as dist
from structured_latent_odes_tpu_torch.prob import fold_seed, sample_normal_ps, seed_tensor, standard_normal_ps
from _torch_one_thread import one_intra_op_thread  # noqa: F401 (autouse)

M32 = 0xFFFFFFFF
SEEDS = [0, 12, 2147483901, (1 << 63) + 5, (1 << 64) - 5]


def _mix(x: int) -> int:
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _word(seed: int, site: str) -> int:
    h = 0x9E3779B9
    for w in (seed & M32, (seed >> 32) & M32, zlib.crc32(site.encode())):
        h = _mix(h ^ w)
    return h


def _fold(seed: int, *words) -> int:
    for w in words:
        seed = (_word(seed, f"fold/{w}") << 32) | _word(seed, f"fold/{w}/lo")
    return seed


def _draws(seed: int, site: str, sids, shape):
    """The draws of one seed as the sampler composed them: words on Python
    ints, then Box-Muller in float64 tensors, cast to float32."""
    n = math.prod(shape)
    word = _word(seed, site)
    rows = []
    for sid in sids.reshape(-1).tolist():
        key = _mix((sid & M32) ^ word)
        rows.append([_mix(key ^ k) >> 8 for k in range(2 * n)])
    u = (torch.tensor(rows, dtype=torch.float64).reshape(*sids.shape, 2 * n) + 0.5) / 16777216.0
    eps = torch.sqrt(-2.0 * torch.log(u[..., 0::2])) * torch.cos(2.0 * math.pi * u[..., 1::2])
    return eps.to(torch.float32).reshape(*sids.shape, *shape)


def _ids(shape, seed=0):
    return torch.randint(-(1 << 40), 1 << 40, shape, generator=torch.Generator().manual_seed(seed))


SHAPES = [(5,), (4,), (2, 3), (1,)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_int_seed_draws_are_the_composition(seed, shape):
    sids = _ids((7,), seed & 0xFF)
    assert torch.equal(standard_normal_ps(seed, "main/iext", sids, shape), _draws(seed, "main/iext", sids, shape))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("seed", SEEDS)
def test_tensor_seed_draws_are_the_int_seeds(seed, shape):
    sids = _ids((6,), 1).to(torch.int32)
    ref = _draws(seed, "aux/rtpr", sids, shape)
    assert torch.equal(standard_normal_ps(seed_tensor([seed])[0], "aux/rtpr", sids, shape), ref)
    assert torch.equal(cn.counter_normal(seed_tensor([seed])[0], "aux/rtpr", sids, math.prod(shape)),
                       ref.reshape(6, -1))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sid_rank", [1, 2], ids=["ids_B", "ids_SB"])
def test_member_seeds_draw_each_members_draws(sid_rank, shape):
    seeds = SEEDS[:3]
    sids = _ids((3, 5), 2) if sid_rank == 2 else _ids((5,), 2)
    got = standard_normal_ps(seed_tensor(seeds), "posterior", sids, shape)
    assert got.shape == (3, 5, *shape)
    for s, seed in enumerate(seeds):
        assert torch.equal(got[s], _draws(seed, "posterior", sids[s] if sid_rank == 2 else sids, shape))
    flat = cn.counter_normal_members(seed_tensor(seeds), "posterior", sids, math.prod(shape))
    assert torch.equal(flat, got.reshape(3, 5, -1))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("sid_dims", [None, 0], ids=["shared_ids", "member_ids"])
def test_vmapped_seeds_draw_each_members_draws(sid_dims, shape):
    seeds = SEEDS[1:4]
    sids = _ids((3, 4), 3) if sid_dims == 0 else _ids((4,), 3)
    got = torch.func.vmap(lambda s, i: standard_normal_ps(s, "main/z_u", i, shape), in_dims=(0, sid_dims))(
        seed_tensor(seeds), sids)
    for s, seed in enumerate(seeds):
        assert torch.equal(got[s], _draws(seed, "main/z_u", sids[s] if sid_dims == 0 else sids, shape))


@pytest.mark.parametrize("words", [("main",), (3, "aux"), ("losses", "main")], ids=["one", "two", "two_str"])
@pytest.mark.parametrize("seed", SEEDS)
def test_folds_of_seed_tensors_are_the_int_folds(seed, words):
    tseed = seed_tensor([seed])[0]
    folded = fold_seed(tseed, *words)
    assert folded.dtype == torch.int64 and folded.shape == ()
    assert int(folded) & ((1 << 64) - 1) == _fold(seed, *words) == fold_seed(seed, *words)
    stack = fold_seed(seed_tensor([seed, 7]), *words)
    assert [int(v) & ((1 << 64) - 1) for v in stack] == [_fold(seed, *words), _fold(7, *words)]


@pytest.mark.parametrize("words", [("main",), (3, "aux")], ids=["one_fold", "two_folds"])
@pytest.mark.parametrize("vmapped", [False, True], ids=["alone", "vmapped"])
def test_draws_after_pending_folds(words, vmapped):
    """A seed tensor folded and then drawn from (the eval functions' losses,
    ``fold_seed(seed, 'main')`` before the sites), alone and under vmap."""
    seeds, sids = SEEDS[:3], _ids((6,), 4)

    def draw(s):
        return sample_normal_ps(fold_seed(s, *words), "main/iext", sids, torch.zeros(6, 5), torch.ones(6, 5))

    if vmapped:
        got = torch.func.vmap(draw)(seed_tensor(seeds))
    else:
        got = torch.stack([draw(seed_tensor([s])[0]) for s in seeds])
    for s, seed in enumerate(seeds):
        assert torch.equal(got[s], _draws(_fold(seed, *words), "main/iext", sids, (5,)))


def test_fold_without_words_is_the_seed():
    tseed = seed_tensor([5, 6])
    assert fold_seed(tseed) is tseed and fold_seed(5) == 5


def test_float64_draws_take_the_plain_version():
    sids = _ids((4,), 5)
    got = standard_normal_ps(9, "x", sids, (3,), dtype=torch.float64)
    assert got.dtype == torch.float64
    assert torch.equal(got.float(), _draws(9, "x", sids, (3,)))


def test_float64_draws_off_the_cpu_raise():
    """Off the CPU the draws are the kernel's float32 alone: no plain version
    runs there."""
    with pytest.raises(ValueError, match="float32"):
        standard_normal_ps(9, "x", torch.arange(4, device="meta"), (3,), dtype=torch.float64)


# (S, B, n) at and just past each of a launch's limits: n and B below 2^31,
# B * n in 2^31 - 1 blocks of 256, S at most 65535; 2 * B * n past 2^31 is
# no limit (the counters run within a row)
LAUNCH_SHAPES = {
    "n at 2^31 - 1": ((1, 1, (1 << 31) - 1), True), "n at 2^31": ((1, 1, 1 << 31), False),
    "B at 2^31 - 1": ((1, (1 << 31) - 1, 1), True), "B at 2^31": ((1, 1 << 31, 1), False),
    "grid.x full": ((1, (1 << 31) - 1, 256), True), "grid.x past": ((1, (1 << 31) - 1, 257), False),
    "S at 65535": ((65535, 128, 5), True), "S at 65536": ((65536, 128, 5), False),
    "2Bn past 2^31": ((10, 1 << 24, 1 << 7), True),
}


@pytest.mark.parametrize("name", sorted(LAUNCH_SHAPES))
def test_launch_limits(name):
    (S, B, n), fits = LAUNCH_SHAPES[name]
    if fits:
        cn.check_shape(S, B, n)
    else:
        with pytest.raises(ValueError, match="limits"):
            cn.check_shape(S, B, n)


def test_fold_takes_at_most_a_launchs_words():
    tseed = seed_tensor([5, 6])
    words = tuple(range(cn.MAX_FOLDS))
    assert torch.equal(fold_seed(tseed, *words), dist.fold_seed_plain(tseed, *words))
    with pytest.raises(ValueError, match="words"):
        fold_seed(tseed, *words, "one more")
    assert fold_seed(5, *words, "one more") == dist.fold_seed_plain(5, *words, "one more")


def test_wrappers_refuse_bad_shapes_and_count_no_launch_on_cpu():
    before = (cn.counter_normal.launches, cn.counter_normal_members.launches, cn.counter_fold.launches)
    with pytest.raises(ValueError):
        cn.counter_normal(seed_tensor([1, 2]), "x", torch.arange(3), 2)
    with pytest.raises(ValueError):
        cn.counter_normal_members(seed_tensor([1, 2]), "x", torch.zeros(3, 4, dtype=torch.long), 2)
    with pytest.raises(ValueError):
        cn.counter_normal_members(seed_tensor([1, 2])[0], "x", torch.arange(3), 2)
    cn.counter_normal(3, "x", torch.arange(3), 2)
    fold_seed(seed_tensor([3]), "a")
    assert (cn.counter_normal.launches, cn.counter_normal_members.launches, cn.counter_fold.launches) == before


def test_kernel_source_holds_the_hash_constants():
    """The CUDA source's constants are the plain version's (a changed hash
    would change the draws everywhere, the benchmark's reference's too)."""
    path = os.path.join(cn._build.CSRC_DIR, "counter_normal.cu")
    src = open(path).read()
    for const in ("0x7FEB352Du", "0x846CA68Bu", "0x9E3779B9u"):
        assert const in src
    assert re.search(r"kMaxFolds = (\d+);", src).group(1) == str(cn.MAX_FOLDS)
    assert re.search(r"kThreads = (\d+);", src).group(1) == str(cn._THREADS)
    assert "1.0 / 16777216.0" in src and "2.0 * 3.141592653589793" in src
    assert float.fromhex((2.0 * 3.141592653589793).hex()) == 2.0 * math.pi
    assert dist._site_word(12, "s") == _word(12, "s")
