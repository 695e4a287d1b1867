"""K1's products one position wide (a matrix-vector row sum) and of
integer operands (row sums that wrap), against the reference's
``run_reference`` and Pallas lowering, and emulated (tolerances:
``tests/test_torch_repairs.py``, whose helpers they use), in a file of
their own so that the suite's ``loadfile`` scheduler runs them beside
``tests/test_differential.py`` rather than ahead of it."""
import pytest
import torch

from tests.test_torch_repairs import (_check_block, _int_product_bodies,
                                      _int_product_env, _one_column_body,
                                      _one_column_env, _text)


@pytest.mark.parametrize("cap", [None, 16])
@pytest.mark.parametrize("body", ["one_column", "int", "int2"])
def test_one_column_and_integer_products_match_reference(body, cap,
                                                         monkeypatch):
    """A product one position wide (a one-column matrix, a one-column
    slice, a one-row matrix times the row, one position of a wider
    product with the cap lowered to 16) is a matrix-vector row sum, not a
    ``tl.dot`` padded to 16 columns; a product of int32 operands (rows
    times a matrix, a vector, a one-column slice; rank 2: an i-row times
    a j-row) is row sums in int32 whose products and sums wrap past 2^31,
    and an int32 matrix cast beside a float row takes the float type, as
    ``jnp.dot`` promotes — each equal to the reference's
    ``run_reference`` (integers bit for bit) and its Pallas lowering, and
    emulated."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import convert, omp
    from repro_torch.kernels import span_kernel

    if body == "one_column":
        prog, jprog = _one_column_body(omp, torch), _one_column_body(jomp, jnp)
        env_np = _one_column_env()
    else:
        at = 0 if body == "int" else 1
        prog = _int_product_bodies(omp, torch)[at]
        jprog = _int_product_bodies(jomp, jnp)[at]
        env_np = _int_product_env()
    if cap is not None:
        monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
    omp.clear_compile_cache()
    _check_block(prog, jprog, env_np)
    text = _text(prog, convert.env_from_numpy(env_np, "cpu"), prog.rank)
    # row sums: [lanes, bk] (one column) or [lanes, bk, n] (integers)
    marks = {"one_column": ("tl.sum(acc", "tl.zeros([16, 16], tl.float32)"),
             "int": ("[:, :, None] *", "], tl.int32)"),
             "int2": ("[:, :, None] *", "], tl.int32)")}[body]
    assert all(m in text for m in marks), text
    omp.clear_compile_cache()
