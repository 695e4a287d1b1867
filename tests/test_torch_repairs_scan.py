"""K1's repairs of scans and sorts (``logcumsumexp``, the values of
``cummax`` / ``cummin``, the indices of a sort, an integer ``pow`` by a
constant) against the reference's ``run_reference`` and Pallas lowering, and
emulated (tolerances: ``tests/test_torch_repairs.py``, whose helpers
they use), in a file of their own so that the suite's ``loadfile``
scheduler runs them beside ``tests/test_differential.py`` rather than
ahead of it."""
import pytest
import torch

from tests.test_torch_repairs import (_argsort_body, _argsort_env,
                                      _assoc_scan_body, _assoc_scan_env,
                                      _check_block, _int_pow_body,
                                      _int_pow_env, _text)


@pytest.mark.parametrize("cap", [None, 16])
@pytest.mark.parametrize("body", ["scan", "argsort", "intpow"])
def test_scan_sort_index_and_int_pow_repairs_match_reference(body, cap,
                                                             monkeypatch):
    """``logcumsumexp`` (rows led by -inf give -inf, not NaN) and the
    values of ``cummax``/``cummin`` (a NaN carried on) along a row as
    ``tl.associative_scan`` — whole, carried tile to tile with the cap
    lowered to 16, rolled, at one position, in a product's grid value
    tile; the indices of a sort of a row with ties, signed zeros and NaN
    (ascending and descending, float and int32, rank 2) from one sorted
    64-bit key; and an int32 ``pow`` by constants 0-7 whose products wrap,
    as repeated squaring — each equal to the reference's
    ``run_reference`` and its Pallas lowering, and emulated."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import convert, omp
    from repro_torch.kernels import span_kernel

    make, env_np = {"scan": (_assoc_scan_body, _assoc_scan_env),
                    "argsort": (_argsort_body, _argsort_env),
                    "intpow": (_int_pow_body, _int_pow_env)}[body]
    env_np = env_np()
    prog, jprog = make(omp, torch), make(jomp, jnp)
    if cap is not None:
        monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
        if body == "argsort":       # a row longer than one register tile
            env = convert.env_from_numpy(env_np, "cpu")
            with pytest.raises(omp.CompileError, match="aten.sort .* 21 "
                               "elements, longer than one register tile"):
                _text(prog, env, 2)
            omp.clear_compile_cache()
            return
    omp.clear_compile_cache()
    _check_block(prog, jprog, env_np)
    text = _text(prog, convert.env_from_numpy(env_np, "cpu"), prog.rank)
    marks = {"scan": ("tl.associative_scan(", "def _scan_lse(a, b):",
                      "def _scan_maxf(a, b):", "def _scan_minf(a, b):",
                      "libdevice.log1p("),
             "argsort": ("tl.sort(", "<< 32", "bitcast=True"),
             "intpow": ("* 0 + 1)",)}[body]
    assert all(m in text for m in marks), text
    if body == "intpow":
        assert "libdevice" not in text, text
    omp.clear_compile_cache()
