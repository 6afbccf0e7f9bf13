"""The loops and counters of the copied physics, as plain host loops:
every trip count and predicate is read on the host, every count is
dropped."""

from __future__ import annotations


def publish(owner, attr: str, value):
    pass


def while_loop(cond_fn, body_fn, carry, counter=None):
    """``carry = body_fn(carry)`` while the 0-d bool ``cond_fn(carry)``
    holds."""
    while bool(cond_fn(carry)):
        carry = body_fn(carry)
    return carry


def fori_loop(n, body_fn, carry):
    """``carry = body_fn(carry)`` ``int(n)`` times."""
    for _ in range(int(n)):
        carry = body_fn(carry)
    return carry
