"""The check that no module of JAX or of the JAX package is loaded compares
whole top-level names."""

import pytest

from portbench.harness.guard import forbidden_loaded


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                  "optax", "hierarchicalgnn_tpu", "hierarchicalgnn_tpu.models"])
def test_rejects(name):
    assert forbidden_loaded(["numpy", name]) == [name.split(".")[0]]


@pytest.mark.parametrize("name", ["hierarchicalgnn_torch", "hierarchicalgnn_torch.models",
                                  "jaxtyping", "flaxen", "portbench.harness"])
def test_accepts(name):
    assert forbidden_loaded([name, "torch"]) == []


def test_the_harness_loads_none():
    import portbench.harness.cli  # noqa: F401
    import portbench.modes  # noqa: F401

    assert "hierarchicalgnn_tpu" not in forbidden_loaded()
