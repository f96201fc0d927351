"""@contract runtime shape/dtype checks of the port
(bucketeer_tpu_torch/analysis/contracts.py): the counterparts of
tests/test_contracts.py, with torch tensors where the JAX test takes
JAX arrays, and the port's 11 decorated entry points held to the JAX
package's specs and verdicts."""
import importlib
import inspect

import numpy as np
import pytest
import torch

from bucketeer_tpu.analysis import contracts as jax_contracts
from bucketeer_tpu_torch.analysis.contracts import (ContractViolation,
                                                    contract,
                                                    contracts_enabled)


def test_enabled_under_pytest():
    # pytest is in sys.modules here, so contracts default to on.
    assert contracts_enabled()


def test_shape_and_symbol_consistency():
    @contract(shapes={"a": ("n", "m"), "b": ("m",)})
    def f(a, b):
        return a @ b

    f(np.zeros((3, 4)), np.zeros(4))
    with pytest.raises(ContractViolation, match="'b'"):
        f(np.zeros((3, 4)), np.zeros(5))      # m mismatch across args


def test_rank_alternatives_and_exact_dims():
    @contract(shapes={"x": [("B", "h", "w"), ("B", "h", "w", 3)]})
    def f(x):
        return x

    f(np.zeros((2, 8, 8)))
    f(np.zeros((2, 8, 8, 3)))
    with pytest.raises(ContractViolation):
        f(np.zeros((2, 8, 8, 4)))             # C must be exactly 3
    with pytest.raises(ContractViolation):
        f(np.zeros(8))                        # no rank-1 alternative


def test_wildcard_and_non_array():
    @contract(shapes={"x": (None, 512)})
    def f(x):
        return x

    f(np.zeros((7, 512), dtype=np.uint8))
    with pytest.raises(ContractViolation, match="array-like"):
        f([1, 2, 3])


def test_dtype_kinds_and_exact():
    @contract(dtypes={"x": "integer", "y": ("float32", "float64"),
                      "z": "uint8"})
    def f(x, y, z):
        return x, y, z

    f(np.zeros(3, np.int64), np.zeros(3, np.float32),
      np.zeros(3, np.uint8))
    with pytest.raises(ContractViolation, match="'x'"):
        f(np.zeros(3, np.float32), np.zeros(3, np.float32),
          np.zeros(3, np.uint8))
    with pytest.raises(ContractViolation, match="'z'"):
        f(np.zeros(3, np.int64), np.zeros(3, np.float64),
          np.zeros(3, np.int8))


def test_checks_torch_tensors_too():
    @contract(shapes={"x": ("n",)}, dtypes={"x": "floating"})
    def f(x):
        return x

    f(torch.zeros(4, dtype=torch.float32))
    with pytest.raises(ContractViolation):
        f(torch.zeros((4, 4), dtype=torch.float32))
    with pytest.raises(ContractViolation):
        f(torch.zeros(4, dtype=torch.int32))


@pytest.mark.parametrize("spec", ["integer", "floating", "unsignedinteger",
                                  "signedinteger", "bool", "number",
                                  "uint8", "int32", "float32", "float64",
                                  "bfloat16"])
def test_torch_and_numpy_dtypes_judged_alike(spec):
    """A tensor and an array of the same dtype pass and fail alike, for
    every kind name and the exact names; bfloat16 (no numpy dtype) is
    floating and matches its own name only."""
    @contract(dtypes={"x": spec})
    def f(x):
        return x

    def verdict(x):
        try:
            f(x)
            return True
        except ContractViolation:
            return False

    for name in ("bool", "uint8", "int8", "int16", "int32", "int64",
                 "float16", "float32", "float64", "complex64"):
        t = torch.zeros(2, dtype=getattr(torch, name))
        a = np.zeros(2, dtype=name)
        assert verdict(t) == verdict(a), (spec, name)
    bf16 = verdict(torch.zeros(2, dtype=torch.bfloat16))
    assert bf16 == (spec in ("floating", "number", "bfloat16"))


def test_env_var_disables(monkeypatch):
    monkeypatch.setenv("BUCKETEER_CONTRACTS", "0")

    def g(x):
        return x

    decorated = contract(shapes={"x": ("n",)})(g)
    assert decorated is g          # no-op at decoration time
    monkeypatch.setenv("BUCKETEER_CONTRACTS", "1")
    decorated = contract(shapes={"x": ("n",)})(g)
    assert decorated is not g


def test_codec_entry_points_are_contracted():
    from bucketeer_tpu_torch.codec import (encoder, frontend, pipeline,
                                           t1_batch)
    from bucketeer_tpu_torch.parallel import batch, sharded_dwt

    for fn in (pipeline.run_tiles, frontend.run_frontend,
               frontend.fetch_payload, encoder.encode_array,
               encoder.encode_jp2, t1_batch.encode_packed,
               batch.run_tiles_sharded,
               sharded_dwt.sharded_dwt2d_forward):
        assert hasattr(fn, "__contract__"), fn

    with pytest.raises(ContractViolation):
        pipeline.run_tiles(None, np.zeros(16))        # rank 1: rejected
    with pytest.raises(ContractViolation):
        encoder.encode_array(np.zeros((4, 4), dtype=object))
    with pytest.raises(ContractViolation):
        encoder.encode_jp2(torch.zeros(4, 4, 2, 2), device="cpu")


# --- the 11 decorated entry points, held to the JAX package's ------------

PAIRS = [("codec.t1_batch", "encode_packed"),
         ("codec.frontend", "dispatch_frontend"),
         ("codec.frontend", "run_frontend"),
         ("codec.frontend", "fetch_payload"),
         ("codec.decode.device", "run_inverse"),
         ("codec.encoder", "encode_array"),
         ("codec.encoder", "encode_jp2"),
         ("codec.pipeline", "run_tiles"),
         ("parallel.batch", "run_tiles_sharded"),
         ("parallel.sharded_dwt", "sharded_dwt2d_forward"),
         ("parallel.sharded_dwt", "sharded_transform_tile")]


def _pair(module: str, name: str):
    jax_fn = getattr(importlib.import_module(f"bucketeer_tpu.{module}"),
                     name)
    port_fn = getattr(importlib.import_module(
        f"bucketeer_tpu_torch.{module}"), name)
    return jax_fn, port_fn


@pytest.mark.parametrize("module,name", PAIRS)
def test_contract_equals_the_jax_spec(module, name):
    jax_fn, port_fn = _pair(module, name)
    assert port_fn.__contract__ == jax_fn.__contract__


_VALID_DTYPE = {"uint8": np.uint8, "integer": np.int32, "number": np.int32}


def _valid_args(spec: dict) -> dict:
    """One valid array per shaped parameter: every symbolic or wildcard
    dimension 2, the first rank alternative, a dtype the spec takes."""
    out = {}
    for pname, shape in spec["shapes"].items():
        alt = shape[0] if isinstance(shape, list) else shape
        dims = tuple(d if isinstance(d, int) else 2 for d in alt)
        dtype = _VALID_DTYPE[spec["dtypes"].get(pname, "number")]
        out[pname] = np.zeros(dims, dtype)
    return out


def _bad_cases(spec: dict) -> list:
    """(label, {param: value}) cases: a valid call, then for the first
    shaped parameter a rank no alternative has, a list, an object array
    and, for a uint8 parameter, a float32 array."""
    valid = _valid_args(spec)
    first = next(iter(spec["shapes"]))
    cases = [("valid", valid),
             ("rank 5", {**valid, first: np.zeros((2,) * 5, np.int32)}),
             ("list", {**valid, first: [1, 2, 3]}),
             ("object dtype", {**valid, first: valid[first].astype(object)})]
    for pname, dtype in spec["dtypes"].items():
        if dtype == "uint8":
            cases.append((f"float32 {pname}",
                          {**valid, pname: valid[pname].astype(np.float32)}))
    return cases


def _probe(fn, decorate):
    """A stand-in with ``fn``'s signature and contract: it checks the
    arguments and returns, running none of ``fn``'s body."""
    def stand_in(*args, **kwargs):
        return "ok"
    stand_in.__signature__ = inspect.signature(inspect.unwrap(fn))
    return decorate(**fn.__contract__)(stand_in)


def _verdict(probe, args: dict, violation) -> str:
    params = inspect.signature(probe).parameters
    call = {p: args.get(p) for p, v in params.items()
            if v.default is inspect.Parameter.empty or p in args}
    try:
        return probe(**call)
    except violation:
        return "violation"


@pytest.mark.parametrize("module,name", PAIRS)
def test_same_inputs_same_verdicts_as_jax(module, name):
    """The same good and bad inputs pass or raise ContractViolation in
    both packages, and a torch tensor is judged as the numpy array of
    the same shape and dtype."""
    jax_fn, port_fn = _pair(module, name)
    spec = port_fn.__contract__
    jax_probe = _probe(jax_fn, jax_contracts.contract)
    port_probe = _probe(port_fn, contract)
    verdicts = []
    for label, args in _bad_cases(spec):
        want = _verdict(jax_probe, args, jax_contracts.ContractViolation)
        got = _verdict(port_probe, args, ContractViolation)
        assert got == want, (label, got, want)
        if all(isinstance(v, np.ndarray) and v.dtype != object
               for v in args.values()):
            tensors = {k: torch.from_numpy(v) for k, v in args.items()}
            assert _verdict(port_probe, tensors, ContractViolation) == \
                want, label
        verdicts.append(want)
    assert verdicts[0] == "ok" and verdicts[1:] == \
        ["violation"] * (len(verdicts) - 1)


def test_real_entry_points_reject_bad_input_in_both():
    """The decorated functions themselves (not stand-ins) reject a
    mis-shaped batch before any op runs, in both packages."""
    from bucketeer_tpu.codec import pipeline as jax_pipeline
    from bucketeer_tpu.codec.decode import device as jax_device
    from bucketeer_tpu_torch.codec import pipeline
    from bucketeer_tpu_torch.codec.decode import device

    for fn, violation in ((jax_pipeline.run_tiles,
                           jax_contracts.ContractViolation),
                          (pipeline.run_tiles, ContractViolation)):
        with pytest.raises(violation):
            fn(None, np.zeros(16))
    for fn, violation in ((jax_device.run_inverse,
                           jax_contracts.ContractViolation),
                          (device.run_inverse, ContractViolation)):
        with pytest.raises(violation):
            fn(None, np.zeros((1, 1, 4, 4), np.float32))
