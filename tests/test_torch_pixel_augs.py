"""The port's on-card pixel battery against ``vats_tpu.data.pixel_augs``.

Every op of the AutoAugment table at fixed magnitudes, on the same images,
against the JAX op (which ``tests/test_pixel_augs.py`` holds to PIL); the
batched op takes one magnitude per image.  Then the random wrappers'
deterministic cores with JAX's own draws (the test replays
``jax.random`` on the same keys as the JAX wrapper): AutoAugment, random
rotation and random erasing must give JAX's images.  Last, the port's
random wrappers by invariants, as the JAX tests check theirs.

Tolerances: photometric ops atol 1e-6 (the same fp32 operations; ops that
quantize to 8 bits exactly equal up to that).  Geometric ops sample the
nearest pixel: exactly equal."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vats_tpu.data import pixel_augs as JPA
from vats_tpu_torch.data import pixel_augs as PA

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=0)


def images(seed=0, b=3, h=32, w=28, quantized=True):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, size=(b, 3, h, w)).astype(np.float32) / 255.0
    return x if quantized else rs.rand(b, 3, h, w).astype(np.float32)


def jax_op(name, x, mags):
    """The JAX op on each image with its magnitude, stacked."""
    fn = getattr(JPA, "_" + name)
    return np.stack([np.asarray(fn(jnp.asarray(img), jnp.float32(m)))
                     for img, m in zip(x, mags)])


CASES = [
    ("shear_x", [-0.3, 0.1, 0.27]), ("shear_y", [0.3, -0.17, 0.0]),
    ("translate_x", [0.25, -0.4, 0.1]), ("translate_y", [-0.3, 0.45, 0.0]),
    ("rotate", [-30.0, 15.0, 90.0]), ("color", [0.1, 1.0, 1.9]),
    ("posterize", [1.0, 4.0, 7.0]), ("solarize", [0.0, 0.5, 0.75]),
    ("contrast", [0.1, 1.0, 1.9]), ("sharpness", [0.0, 1.0, 2.0]),
    ("brightness", [0.1, 0.55, 1.9]), ("autocontrast", [0.0] * 3),
    ("equalize", [0.0] * 3), ("invert", [0.0] * 3), ("identity", [0.0] * 3),
]


@pytest.mark.parametrize("name,mags", CASES)
@pytest.mark.parametrize("quantized", [True, False])
def test_op_matches_jax_per_image_magnitude(name, mags, quantized):
    x = images(1, quantized=quantized)
    got = getattr(PA, name)(torch.from_numpy(x), torch.tensor(mags)).numpy()
    want = jax_op(name, x, mags)
    if name in ("shear_x", "shear_y", "translate_x", "translate_y", "rotate"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


def test_op_table_is_jaxs():
    assert [f.__name__ for f in PA.OPS] == [f.__name__.lstrip("_") for f in JPA._OPS]
    np.testing.assert_array_equal(PA._P_OP, JPA._P_OP)
    np.testing.assert_array_equal(PA._P_MAG, JPA._P_MAG)
    np.testing.assert_array_equal(PA._P_PROB, JPA._P_PROB)


def test_equalize_flat_and_two_level_channels():
    """A constant channel (step 0) is kept; a channel with two values."""
    x = np.zeros((2, 3, 8, 8), np.float32)
    x[0] = 0.5
    x[1, :, :4] = 0.2
    x[1, :, 4:] = 0.9
    got = PA.equalize(torch.from_numpy(x)).numpy()
    want = jax_op("equalize", x, [0.0, 0.0])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got[0], x[0])


def test_autoaugment_core_matches_jax_with_its_draws():
    x = images(2, b=6)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JPA.autoaugment_imagenet(key, jnp.asarray(x)))
    sp, us, signs = [], [], []
    for k in jax.random.split(key, x.shape[0]):  # the JAX wrapper's own draws
        r_sp, r_u, r_sign = jax.random.split(k, 3)
        sp.append(int(jax.random.randint(r_sp, (), 0, 25)))
        us.append(np.asarray(jax.random.uniform(r_u, (2,))))
        signs.append(np.where(np.asarray(jax.random.bernoulli(r_sign, 0.5, (2,))), 1.0, -1.0))
    got = PA.autoaugment_apply(torch.from_numpy(x), torch.tensor(sp),
                               torch.from_numpy(np.stack(us)),
                               torch.from_numpy(np.stack(signs))).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_every_sub_policy_matches_jax():
    """Each of the 25 sub-policies with both stages applied, signs + and -."""
    x = images(4, b=25, h=16, w=16)
    sp = torch.arange(25)
    for sign in (1.0, -1.0):
        signs = torch.full((25, 2), sign)
        got = PA.autoaugment_apply(torch.from_numpy(x), sp, torch.zeros(25, 2), signs)
        for i in range(25):
            img = jnp.asarray(x[i])
            for stage in range(2):
                op, m = int(JPA._P_OP[i, stage]), float(JPA._P_MAG[i, stage])
                s = sign if JPA._P_SIGNED[i, stage] else 1.0
                m = 1.0 + s * m if JPA._P_ENHANCER[i, stage] else s * m
                if JPA._P_PROB[i, stage] > 0:
                    img = JPA._OPS[op](img, jnp.float32(m))
            np.testing.assert_allclose(got[i].numpy(), np.asarray(img), err_msg=str(i),
                                       **TOL)


def test_random_rotation_and_erasing_cores_match_jax_with_its_draws():
    x = images(5, b=8)
    key = jax.random.PRNGKey(6)
    want = np.asarray(JPA.random_rotation(key, jnp.asarray(x), 15.0))
    angles = np.asarray(jax.random.uniform(key, (8,), minval=-15.0, maxval=15.0))
    got = PA.rotate(torch.from_numpy(x), torch.from_numpy(angles.copy())).numpy()
    np.testing.assert_array_equal(got, want)

    want = np.asarray(JPA.random_erasing(key, jnp.asarray(x), p=0.5))
    r_apply, r_area, r_ratio, r_x, r_y = jax.random.split(key, 5)
    draws = [jax.random.bernoulli(r_apply, 0.5, (8,)),
             jax.random.uniform(r_area, (8,), minval=0.02, maxval=0.33),
             jax.random.uniform(r_ratio, (8,), minval=math.log(0.3), maxval=math.log(3.3)),
             jax.random.uniform(r_y, (8,)), jax.random.uniform(r_x, (8,))]
    got = PA.erase_boxes(torch.from_numpy(x), *(torch.from_numpy(np.array(d)) for d in draws))
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_wrappers_invariants():
    gen = lambda s: torch.Generator().manual_seed(s)  # noqa: E731
    x = torch.from_numpy(images(7, b=8))
    out = PA.autoaugment_imagenet(gen(0), x)
    assert out.shape == x.shape and out.dtype == x.dtype
    assert bool(torch.isfinite(out).all()) and float(out.min()) >= 0 and float(out.max()) <= 1
    assert not torch.allclose(PA.autoaugment_imagenet(gen(7), x), out)
    assert torch.equal(PA.autoaugment_imagenet(gen(0), x), out)  # seeded
    ones = torch.ones(4, 3, 16, 16)
    rot = PA.random_rotation(gen(0), ones)
    assert set(torch.unique(rot).tolist()) <= {0.0, 1.0}
    er = PA.random_erasing(gen(0), torch.ones(16, 3, 32, 32), p=1.0)
    frac = (er == 0).reshape(16, -1).float().mean(1)
    assert bool((frac > 0).all()) and bool((frac < 0.5).all())
    assert torch.equal(PA.random_erasing(gen(0), ones, p=0.0), ones)
