"""The run's import guard compares whole top-level module names."""
from cb.guard import forbidden_modules


def test_port_passes_and_jax_package_trips():
    assert forbidden_modules(["repro_torch", "repro_torch.train.step",
                              "torch", "numpy"]) == []
    assert forbidden_modules(["repro", "repro_torch"]) == ["repro"]
    assert forbidden_modules(["repro.models.moe"]) == ["repro"]
    assert forbidden_modules(["jax.numpy", "jaxlib.xla_client",
                              "flax.linen"]) == ["flax", "jax", "jaxlib"]
    assert forbidden_modules(["jaxtyping", "reprolib", "flaxen"]) == []


def test_this_process_loads_none():
    import cb.train_cell  # noqa: F401  (the harness and the port)
    import repro_torch.train.step  # noqa: F401
    assert forbidden_modules() == []
