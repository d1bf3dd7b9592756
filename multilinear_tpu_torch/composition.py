"""A sumcheck composition traced once to a straight-line program, and the
two kernels of a constraint-sumcheck round that run it
(``csrc/sumcheck_round.cu``).

:func:`trace` calls the composition once over stand-ins for the columns
and the aux scalars and records every ``+``, ``-``, ``*`` and unary ``-``
it makes - the whole contract a constraint is written against - as one
instruction over slots.  Nothing is evaluated: the program holds the
composition's arithmetic, and a round evaluates it at every extension
point of every row pair.  This is the one place the prover calls a
composition (the verifier calls it over host ``Fp``).  A composition that
steps outside the contract raises (``TypeError``); one that returns a host
scalar is a program with a constant result.  Programs are cached by
(composition, columns, aux count): a constraint set is traced once a
process, not once a proof.

An operand is a slot (``>= 0``: the columns the program reads, at the
current point, then the temporaries) or a scalar (``< 0``: scalar
``-1 - o`` of the aux scalars followed by the program's constants).  The
packed form, an int32 array, is what the kernel reads (the plain version
reads the instructions from the :class:`Program`, and its constants from
the packed copy on the table's device):

* words 0-7: columns read, temporaries, instructions, result operand,
  constants, aux scalars, 0, 0;
* the constants, four limbs each (16-byte aligned);
* the instructions, four words each: op, destination slot, a, b;
* the trace column of each column slot.

The kernels (a CUDA tensor launches them, a CPU tensor runs the plain
version beside each; counted in ``stats`` as ``launch.<kernel>``):

* ``sumcheck_sums`` - the round's unreduced limb sums of s(1)..s(d): each
  row pair of the packed (w+1, h, 4) table read once, the extensions formed
  incrementally, the program run at each point and weighted by the delta
  row's extension, the limbs added into int64 lanes.  :func:`round_sums`
  decides the route: the kernel where the program fits a block of the
  card, else the plain version's loop (:func:`evaluate`) over the card's
  add, sub and mul kernels;
* ``sumcheck_fold`` - the whole table folded with the round's challenge,
  lo + r (hi - lo), in one pass: every sumcheck table's fold, the PCS's
  included.
"""

from __future__ import annotations

import heapq
from functools import lru_cache
from typing import Optional

import numpy as np
import torch

from . import stats
from .field import cuda_ops, limbs, ops
from .field.scalar import Fp

OP_ADD, OP_SUB, OP_MUL, OP_NEG = range(4)
HEADER_WORDS = 8


class _Sym:
    """A stand-in for a field value while a composition is traced:
    each operation records one instruction and returns its result's
    stand-in."""

    __slots__ = ("tracer", "ref")

    def __init__(self, tracer: "_Tracer", ref: tuple):
        self.tracer = tracer
        self.ref = ref

    def __add__(self, o):
        return self.tracer.op(OP_ADD, self, o)

    __radd__ = __add__

    def __sub__(self, o):
        return self.tracer.op(OP_SUB, self, o)

    def __rsub__(self, o):
        return self.tracer.op(OP_SUB, o, self)

    def __mul__(self, o):
        return self.tracer.op(OP_MUL, self, o)

    __rmul__ = __mul__

    def __neg__(self):
        return self.tracer.op(OP_NEG, self, None)


class _Tracer:
    """The instructions recorded so far, as (op, a, b) over references:
    ("col", j), ("aux", k), ("const", v) or ("tmp", i), the result of
    instruction i."""

    def __init__(self):
        self.nodes = []

    def ref(self, o) -> tuple:
        if isinstance(o, _Sym) and o.tracer is self:
            return o.ref
        if isinstance(o, (int, Fp)):
            # Fp semantics, as the verifier's host arithmetic reads a
            # constant (a negative int wraps mod 2^128 first, Q4)
            return ("const", Fp(o).v)
        raise TypeError(f"cannot combine a field value with {type(o).__name__}")

    def op(self, op: int, a, b):
        self.nodes.append((op, self.ref(a), None if b is None else self.ref(b)))
        return _Sym(self, ("tmp", len(self.nodes) - 1))


class Program:
    """A traced composition; ``packed`` is its int32 form (module docstring)."""

    def __init__(self, cols, n_temps, instrs, result, consts, n_aux):
        self.cols, self.n_temps, self.instrs = tuple(cols), n_temps, tuple(instrs)
        self.result, self.consts, self.n_aux = result, tuple(consts), n_aux
        head = [len(self.cols), n_temps, len(self.instrs), result, len(self.consts), n_aux, 0, 0]
        const_words = limbs.pack_ints(list(self.consts)).reshape(-1).tolist()
        words = head + const_words + [w for ins in self.instrs for w in ins] + list(self.cols)
        self.packed = np.asarray(words, dtype=np.int64).astype(np.int32)
        self._on = {}

    def slots(self, degree: int) -> int:
        """Slots a thread of ``sumcheck_sums`` holds: the columns' values at
        the point, the temporaries, and above degree 1 the columns' steps
        hi - lo."""
        return len(self.cols) * (2 if degree > 1 else 1) + self.n_temps

    def on(self, device) -> torch.Tensor:
        """The packed program on ``device``, copied there once."""
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = limbs.to_device(torch.from_numpy(self.packed.copy()), device)
        return self._on[device]


@lru_cache(maxsize=64)
def trace(composition, n_cols: int, n_aux: Optional[int]) -> Program:
    """The program of ``composition`` over ``n_cols`` columns and ``n_aux``
    aux scalars (None: the one-argument convention, composition(cols))."""
    tracer = _Tracer()
    cols = [_Sym(tracer, ("col", j)) for j in range(n_cols)]
    try:
        if n_aux is None:
            out = composition(cols)
        else:
            out = composition(cols, [_Sym(tracer, ("aux", k)) for k in range(n_aux)])
    except (TypeError, AttributeError) as e:
        raise TypeError("the composition steps outside the field's arithmetic (+, -, * and unary - over "
                        f"the columns, the aux scalars and int or Fp constants): {e}") from e
    if not isinstance(out, (_Sym, int, Fp)):
        raise TypeError(f"the composition returned a {type(out).__name__}, not a field value")
    return _compile(tracer.nodes, tracer.ref(out), 0 if n_aux is None else n_aux)


def _compile(nodes, result_ref, n_aux: int) -> Program:
    """Slots for the instructions the result needs, in recorded order: each
    temporary's slot is freed after its last read and reused."""
    live, stack = set(), [result_ref]
    while stack:
        r = stack.pop()
        if r is not None and r[0] == "tmp" and r[1] not in live:
            live.add(r[1])
            stack += nodes[r[1]][1:]
    order = sorted(live)
    refs = [r for i in order for r in nodes[i][1:] if r is not None] + [result_ref]
    cols = sorted({r[1] for r in refs if r[0] == "col"})
    col_slot = {c: u for u, c in enumerate(cols)}
    consts = list(dict.fromkeys(r[1] for r in refs if r[0] == "const"))
    const_index = {v: k for k, v in enumerate(consts)}
    last_read = {}
    for i in order:
        for r in nodes[i][1:]:
            if r is not None and r[0] == "tmp":
                last_read[r[1]] = i
    tmp_slot, free, n_temps = {}, [], 0

    def operand(r):
        if r is None:
            return 0
        kind, v = r
        if kind == "col":
            return col_slot[v]
        if kind == "tmp":
            return len(cols) + tmp_slot[v]
        return -1 - (v if kind == "aux" else n_aux + const_index[v])

    instrs = []
    for i in order:
        op, a, b = nodes[i]
        ea, eb = operand(a), operand(b)
        for t in {r[1] for r in (a, b) if r is not None and r[0] == "tmp"}:
            if last_read[t] == i:
                heapq.heappush(free, tmp_slot[t])
        if free:
            tmp_slot[i] = heapq.heappop(free)
        else:
            tmp_slot[i], n_temps = n_temps, n_temps + 1
        instrs.append((op, len(cols) + tmp_slot[i], ea, eb))
    return Program(cols, n_temps, instrs, operand(result_ref), consts, n_aux)


# ---------------------------------------------------------------------------
# sumcheck_sums: the round's sums
# ---------------------------------------------------------------------------

_MAX_SLOTS: dict = {}


def max_slots(device) -> Optional[int]:
    """The most slots ``sumcheck_sums`` gives a thread on ``device``: None
    (no limit) on the CPU; on a card what one block of 32 threads holds in
    shared memory (asked of the card once)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _MAX_SLOTS:
        from . import _build

        limit = _build.lib()["mlt_sumcheck_max_slots"](index)
        if limit < 1:
            raise RuntimeError(f"the shared memory of card {index} could not be read")
        _MAX_SLOTS[index] = limit
    return _MAX_SLOTS[index]


def evaluate(program: Program, slots, scalars, prims):
    """The program's value at one point: ``slots`` the values of its column
    slots (the trace columns ``Program.cols`` names, in that order),
    ``scalars`` its aux scalars then its constants, ``prims`` the field's
    (add, sub, mul) to run it on - the plain versions, or ``ops.add``,
    ``ops.sub`` and ``ops.mul``, which launch the device's kernels."""
    values = dict(enumerate(slots))

    def val(o):
        return values[o] if o >= 0 else scalars[-1 - o]

    for op, dst, a, b in program.instrs:
        x = val(a)
        values[dst] = prims[OP_SUB](x.new_zeros(4), x) if op == OP_NEG else prims[op](x, val(b))
    return val(program.result)


def _sums_loop(data: torch.Tensor, program: Program, aux: Optional[torch.Tensor], degree: int, out: torch.Tensor,
               prims) -> None:
    """Adds s(1)..s(degree) into ``out``, the program run by
    :func:`evaluate` over whole extensions of the table halves; its
    constants are read as (4,) views of the packed program on the table's
    device (``Program.on``)."""
    n_consts = len(program.consts)
    consts = program.on(data.device)[HEADER_WORDS : HEADER_WORDS + 4 * n_consts].view(n_consts, 4)
    scalars = list(aux[: program.n_aux] if program.n_aux else []) + list(consts)
    add, sub, mul = prims
    w, half = data.shape[0] - 1, data.shape[1] // 2
    lo, hi = data[:, :half], data[:, half:]
    cur = hi
    for x in range(1, degree + 1):
        if x == 2:
            step = sub(hi, lo)
        if x > 1:
            cur = add(cur, step)
        res = evaluate(program, [cur[c] for c in program.cols], scalars, prims)
        out[x - 1] += ops.sum_limbs(mul(cur[w], res), dim=0)


_PLAIN = (ops.add_plain, ops.sub_plain, cuda_ops.mul_plain)


def round_sums_plain(data: torch.Tensor, program: Program, aux: Optional[torch.Tensor], degree: int,
                     out: torch.Tensor) -> None:
    """What one launch of ``sumcheck_sums`` does, in tensor code: adds the
    unreduced limb sums of s(1)..s(degree) into ``out`` ((degree, 4) int64),
    s(X) = sum_i delta_X[i] * program(cols_X)[i] over the row pairs
    (i, i + h/2) of ``data`` (w+1, h, 4), the delta row last."""
    _sums_loop(data, program, aux, degree, out, _PLAIN)


def round_sums(data: torch.Tensor, program: Program, aux: Optional[torch.Tensor], degree: int,
               out: torch.Tensor) -> None:
    """Add the round's unreduced limb sums of s(1)..s(degree) into ``out``
    ((degree, 4) int64, zero before a round: the kernel adds with atomics);
    arguments as in :func:`round_sums_plain`, ``aux`` the (n_aux, 4) aux
    scalars the program reads, or None if it reads none.

    The route is chosen here, from the tensor's device and the program's
    width: on a card, a program that fits a block (:func:`max_slots`) runs
    in one ``sumcheck_sums`` launch, and a wider one runs the plain
    version's loop over ``ops.add``, ``ops.sub`` and ``ops.mul`` (a launch
    an operation); a CPU tensor, which has no limit, runs the plain version.
    ``stats`` counts the rounds that take the kernel or its plain version
    as ``sumcheck_rounds_fused``."""
    cuda_ops._check_field("sumcheck_sums: data", data)
    if data.dim() != 3 or data.shape[1] < 2 or data.shape[1] & (data.shape[1] - 1):
        raise ValueError(f"sumcheck_sums: expected a (w+1, h, 4) table, h a power of two >= 2, "
                         f"got {tuple(data.shape)}")
    if data.shape[1] // 2 >= 1 << 31:
        raise ValueError("a round's unreduced limb sums stay exact for fewer than 2^31 rows")
    w = data.shape[0] - 1
    if program.cols and program.cols[-1] >= w:
        raise ValueError(f"sumcheck_sums: the program reads column {program.cols[-1]} of {w}")
    if program.n_aux:
        cuda_ops._check_field("sumcheck_sums: aux", aux, device=data.device)
        if aux.shape != (program.n_aux, 4):
            raise ValueError(f"sumcheck_sums: the program reads {program.n_aux} aux scalars, got "
                             f"{tuple(aux.shape)}")
    if not isinstance(out, torch.Tensor) or out.dtype != torch.int64 or tuple(out.shape) != (degree, 4) \
            or not out.is_contiguous() or out.device != data.device or degree < 1:
        raise ValueError(f"sumcheck_sums: out must be a contiguous ({degree}, 4) int64 tensor on {data.device}, "
                         "degree >= 1")
    slots, limit = program.slots(degree), max_slots(data.device)
    if limit is not None and slots > limit:
        _sums_loop(data, program, aux, degree, out, (ops.add, ops.sub, ops.mul))
        return
    stats.bump("sumcheck_rounds_fused")
    if data.device.type == "cpu":
        round_sums_plain(data, program, aux, degree, out)
        return
    cuda_ops._launch("sumcheck_sums", "mlt_sumcheck_sums", data.device, data.data_ptr(), data.shape[1], w,
                     degree, program.on(data.device).data_ptr(), slots,
                     aux.data_ptr() if program.n_aux else None, program.n_aux, out.data_ptr())


# ---------------------------------------------------------------------------
# sumcheck_fold: the table fold
# ---------------------------------------------------------------------------


def round_fold_plain(data: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """lo + r (hi - lo) over the row pairs (i, i + h/2) of every row of
    ``data`` (w+1, h, 4): (w+1, h/2, 4)."""
    half = data.shape[1] // 2
    lo, hi = data[:, :half], data[:, half:]
    return ops.add_plain(lo, cuda_ops.mul_plain(ops.sub_plain(hi, lo), r))


def round_fold(data: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """The packed table folded with the challenge ``r``, a (4,) field
    element on the table's device (where the round's Fiat-Shamir kernel
    drew it), into a new contiguous (w+1, h/2, 4) tensor."""
    cuda_ops._check_field("sumcheck_fold: data", data)
    cuda_ops._check_field("sumcheck_fold: r", r, device=data.device)
    if data.dim() != 3 or data.shape[1] < 2 or data.shape[1] % 2 or r.shape != (4,):
        raise ValueError(f"sumcheck_fold: bad shapes {tuple(data.shape)}, {tuple(r.shape)}")
    if data.device.type == "cpu":
        return round_fold_plain(data, r)
    rows, h = data.shape[0], data.shape[1]
    out = torch.empty((rows, h // 2, 4), dtype=torch.int32, device=data.device)
    cuda_ops._check_count("sumcheck_fold", rows * (h // 2))
    cuda_ops._launch("sumcheck_fold", "mlt_sumcheck_fold", data.device, data.data_ptr(), out.data_ptr(), rows, h,
                     r.data_ptr())
    return out
