"""Port of `cosnarks_tpu.gadgets.sort`: host Python, copied unchanged.

Oblivious sorting gadgets for Rep3 field shares.

Counterpart of the reference's rep3 sort gadget
(mpc-core/src/protocols/rep3/gadgets/sort.rs:14,
batcher_odd_even_merge_sort_yao): the comparison network runs inside ONE
garbled circuit, so the whole sort costs two network messages regardless
of input size — vs O(log^2 n) comparison rounds for an in-protocol
network. The ring-share radix sort (rep3_ring/gadgets/sort.rs analog)
lives in mpc/rep3_ring.py:radix_sort_fields.
"""

from __future__ import annotations

from ..mpc import yao, yao_circuits as yc
from ..mpc.rep3_scalar import Rep3Scalar


def batcher_odd_even_merge_sort_yao(proto: Rep3Scalar, inputs,
                                    bitsize: int):
    """Sort Rep3 field shares ascending by their low `bitsize` bits.

    Returns field shares of the sorted truncated values (like the
    reference: "the final results also only have bitsize bits each").
    Two messages total: garblers -> evaluator (a2y + circuit), evaluator
    -> party 0 (y2b), plus the local b2a bit-composition.
    """
    if bitsize > proto.p.bit_length():
        raise ValueError("bitsize larger than the field size")
    if not inputs:
        return []
    engine = yao.Rep3Yao(proto)
    wires = engine.a2y_joint(
        inputs,
        lambda f, triples, pbits: yc.batcher_sort_mod_p(
            f, triples, pbits, bitsize),
    )
    return engine.b2a_many(engine.y2b_many(wires))
