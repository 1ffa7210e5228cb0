"""OR disjunction of gadget blocks (reference src/or/or_conjunction.rs).

Replays every clause's multiplications/allocations into the main CS, then for
every element of the Cartesian product (one constraint picked per clause)
multiplies the picks and constrains the product to zero: satisfied iff at
least one clause has all of its constraints equal to zero.
"""

from itertools import product as cartesian_product

from ..core.recorder import (OP_MULTIPLY, OP_ALLOCATE, OP_CONSTRAIN,
                             OP_COMMIT)


def or_gadget(main_cs, buffer):
    """main_cs: the parent RecordingCS (or a real CS); buffer: RecordingCS
    whose cached_buffers hold one op log per clause."""
    constraints_vec = []
    for operations in buffer.buffer_cache():
        constraints = []
        for op, payload in operations:
            if op == OP_MULTIPLY:
                left, right = payload
                main_cs.multiply(left, right)
            elif op == OP_ALLOCATE:
                main_cs.allocate_multiplier(payload[0],
                                            _bit_source=payload[1])
            elif op == OP_CONSTRAIN:
                constraints.append(payload)
            elif op == OP_COMMIT:
                pass  # already committed to the main prover
        constraints_vec.append(constraints)

    for combo in cartesian_product(*constraints_vec):
        if not combo:
            continue
        constraint_product = combo[0]
        for lc in combo[1:]:
            _, _, product_var = main_cs.multiply(constraint_product, lc)
            constraint_product = product_var.lc()
        main_cs.constrain(constraint_product)
