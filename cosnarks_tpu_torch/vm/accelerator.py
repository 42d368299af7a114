"""Port of `cosnarks_tpu.vm.accelerator`: host Python, copied unchanged.

MPC accelerator registry for the witness-extension VM.

Counterpart of the reference's MpcAccelerator / MpcAcceleratorConfig
(co-circom/circom-mpc-vm/src/accelerator.rs:44-171): named circom functions
and whole components are replaced by driver-level protocol ops so that
bit-decomposition-heavy templates cost one A2B instead of hundreds of
per-signal conversions. The replacement must reproduce the template's
*exact* witness trace — outputs and intermediate signals — so recombined
MPC witnesses stay bit-identical to plain circom execution.

Env config mirrors the reference: CIRCOM_MPC_ACCELERATOR_<NAME> in
{1,true,on,0,false,off}, default on, for NAME in SQRT, NUM2BITS, ADDBITS,
ISZERO, POSEIDON2 (accelerator.rs:100-121).
"""

from __future__ import annotations

import dataclasses
import os


def _env_bool(name: str) -> bool:
    v = os.environ.get(name)
    if v is None:
        return True
    return v.lower() not in ("0", "false", "off")


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    sqrt: bool = True
    num2bits: bool = True
    addbits: bool = True
    iszero: bool = True
    poseidon2: bool = True

    @classmethod
    def from_env(cls) -> "AcceleratorConfig":
        return cls(
            sqrt=_env_bool("CIRCOM_MPC_ACCELERATOR_SQRT"),
            num2bits=_env_bool("CIRCOM_MPC_ACCELERATOR_NUM2BITS"),
            addbits=_env_bool("CIRCOM_MPC_ACCELERATOR_ADDBITS"),
            iszero=_env_bool("CIRCOM_MPC_ACCELERATOR_ISZERO"),
            poseidon2=_env_bool("CIRCOM_MPC_ACCELERATOR_POSEIDON2"),
        )


class MpcAccelerator:
    """Function- and component-level replacements, dispatched by name during
    VM execution (accelerator.rs:124-300). Component handlers take
    (driver, flat_inputs, n_outputs) and return (outputs, intermediates);
    function handlers take (driver, args) and return the value."""

    def __init__(self, config: AcceleratorConfig | None = None):
        cfg = config or AcceleratorConfig.from_env()
        self.functions = {}
        self.components = {}
        if cfg.sqrt:
            self.functions["sqrt"] = _fn_sqrt
        if cfg.num2bits:
            self.components["Num2Bits"] = _cmp_num2bits
        if cfg.addbits:
            self.components["AddBits"] = _cmp_addbits
        if cfg.iszero:
            self.components["IsZero"] = _cmp_iszero
        if cfg.poseidon2:
            self.components["Poseidon2"] = _cmp_poseidon2

    def has_fn(self, name: str) -> bool:
        return name in self.functions

    def has_cmp(self, name: str, n_inputs: int) -> bool:
        if name not in self.components:
            return False
        # only Poseidon2 state sizes 2,3,4,16 are supported (mpc_vm.rs:330)
        if name == "Poseidon2" and n_inputs not in (2, 3, 4, 16):
            return False
        return True

    def run_fn(self, name, driver, args):
        return self.functions[name](driver, args)

    def run_cmp(self, name, driver, inputs, n_outputs):
        return self.components[name](driver, inputs, n_outputs)


def _fn_sqrt(driver, args):
    """circomlib's `function sqrt(n)` (pointbits.circom:27): Tonelli-Shanks
    normalized to the root in [0, p/2] (reference register_sqrt +
    mpc/rep3.rs:243-258)."""
    if len(args) != 1:
        raise ValueError("sqrt accelerator takes one argument")
    return driver.sqrt(args[0])


def _cmp_num2bits(driver, inputs, n_outputs):
    """circomlib Num2Bits(n): out[i] = bit i of in (accelerator.rs:199)."""
    if len(inputs) != 1:
        raise ValueError("Num2Bits accelerator takes one input")
    return driver.num2bits(inputs[0], n_outputs), []


def _cmp_addbits(driver, inputs, n_outputs):
    """reclaim AddBits(BITS): MSB-first bitwise add with carry intermediate
    (accelerator.rs:214-228)."""
    if len(inputs) % 2 != 0:
        raise ValueError("AddBits accelerator needs an even input count")
    half = len(inputs) // 2
    out, carry = driver.addbits(inputs[:half], inputs[half:])
    return out, [carry]


def _cmp_iszero(driver, inputs, n_outputs):
    """circomlib IsZero: out = (in == 0), intermediate inv = 1/(in+out) - out
    (accelerator.rs:231-246 — generic over driver ops)."""
    if len(inputs) != 1:
        raise ValueError("IsZero accelerator takes one input")
    x = inputs[0]
    is_zero = driver.eq(x, 0)
    inv = driver.sub(driver.div(1, driver.add(x, is_zero)), is_zero)
    return [is_zero], [inv]


def _cmp_poseidon2(driver, inputs, n_outputs):
    """Poseidon2 permutation component t in {2,3,4,16}
    (accelerator.rs:249-273): outputs the full end state, intermediates are
    the circom trace signals."""
    return driver.poseidon2(list(inputs))
