"""Input validation and error paths (reference: tests/src/test_validate.c,
test_error_handling.c; validate.c:18-221)."""

import numpy as np
import pytest

from qpalm_jax import QPALM, Settings
from qpalm_jax.validate import ValidationError, validate_settings


def _mk(**kw):
    return QPALM(np.eye(2), np.ones((1, 2)), np.zeros(2),
                 np.array([0.0]), np.array([1.0]), **kw)


def test_bounds_crossed():
    with pytest.raises(ValidationError):
        QPALM(np.eye(1), np.ones((1, 1)), np.zeros(1),
              np.array([2.0]), np.array([1.0]))


def test_shape_mismatches():
    with pytest.raises(ValidationError):
        QPALM(np.eye(2), np.ones((1, 3)), np.zeros(2),
              np.array([0.0]), np.array([1.0]))
    with pytest.raises(ValidationError):
        QPALM(np.eye(2), np.ones((1, 2)), np.zeros(3),
              np.array([0.0]), np.array([1.0]))
    with pytest.raises(ValidationError):
        QPALM(np.ones((2, 3)), np.ones((1, 2)), np.zeros(2),
              np.array([0.0]), np.array([1.0]))


# every settings range check from reference validate.c:43-221
BAD_SETTINGS = [
    dict(max_iter=0),
    dict(inner_max_iter=0),
    dict(eps_abs=-1.0),
    dict(eps_rel=-1.0),
    dict(eps_abs=0.0, eps_rel=0.0),
    dict(eps_abs_in=-1.0),
    dict(eps_rel_in=-1.0),
    dict(rho=1.0),
    dict(rho=0.0),
    dict(eps_prim_inf=-1e-3),
    dict(eps_dual_inf=-1e-3),
    dict(theta=1.5),
    dict(delta=0.5),
    dict(sigma_max=0.0),
    dict(sigma_init=0.0),
    dict(gamma_init=0.0),
    dict(gamma_upd=0.5),
    dict(gamma_max=0.0),
    dict(scaling=-1),
    dict(print_iter=0),
    dict(reset_newton_iter=0),
    dict(time_limit=0.0),
]


@pytest.mark.parametrize("kw", BAD_SETTINGS, ids=[str(k) for k in BAD_SETTINGS])
def test_bad_settings_rejected(kw):
    with pytest.raises(ValidationError):
        validate_settings(Settings(**kw))


def test_good_settings_pass():
    validate_settings(Settings())
    validate_settings(Settings(eps_abs=0.0, eps_rel=1e-9))
    validate_settings(Settings(dtype="float32", max_refine=0))
