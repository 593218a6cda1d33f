"""A minimal Lua 5.1 interpreter for Redis EVAL scripts.

The port's copy of ``xaynet_tpu/utils/lua_mini.py``. The Redis
coordinator storage guards its conditional inserts with Lua scripts
(``storage/redis.py``; reference:
rust/xaynet-server/src/storage/coordinator_storage/redis/mod.rs:208-343).
A test double of Redis (and ``chip_smoke.py``'s in-process RESP server)
runs the real script text through this module, so a syntax error in a
script fails loudly instead of going unnoticed.

It implements the subset Redis scripting actually needs here, with Lua 5.1
semantics where they matter:

- values: nil, booleans, numbers (doubles), strings (Python ``bytes`` —
  Redis strings are binary-safe);
- 1-based table indexing of ``KEYS``/``ARGV``, the ``#`` length operator;
- ``local`` declarations, ``if/elseif/else``, numeric ``for`` with step,
  ``while``, ``return``, ``break``;
- operators: ``+ - * / %``, ``..``, ``== ~= < <= > >=``, ``and or not``
  (with Lua truthiness: only nil and false are falsy; ``and``/``or``
  return operands, not booleans);
- host functions: ``redis.call`` / ``redis.pcall``, ``tonumber``,
  ``tostring``, ``redis.error_reply``, ``redis.status_reply``;
- Redis type mapping on call results and on the final return value
  (number -> integer truncation, false -> nil, table -> array), exactly
  the conversion table documented for EVAL.

It is intentionally NOT a full Lua: no functions, closures, metatables,
goto, varargs, or the standard library beyond the functions above. Any
construct outside the subset raises ``LuaError`` at parse time — which is
precisely the point: a malformed script must fail loudly in tests.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Callable, Optional


class LuaError(Exception):
    """Raised for Lua syntax errors and runtime errors."""


# --------------------------------------------------------------------------
# Lexer
# --------------------------------------------------------------------------

_KEYWORDS = {
    "and", "break", "do", "else", "elseif", "end", "false", "for", "if",
    "in", "local", "nil", "not", "or", "repeat", "return", "then", "true",
    "until", "while", "function",
}

_TOKEN_RE = re.compile(
    rb"""
    (?P<ws>\s+)
  | (?P<comment>--\[\[.*?\]\]|--[^\n]*)
  | (?P<number>0[xX][0-9a-fA-F]+|\d+\.?\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<string>"(?:\\.|[^"\\])*"|'(?:\\.|[^'\\])*')
  | (?P<op>\.\.\.|\.\.|==|~=|<=|>=|[-+*/%#<>=(){}\[\];:,.])
    """,
    re.VERBOSE | re.DOTALL,
)

_ESCAPES = {
    b"n": b"\n", b"t": b"\t", b"r": b"\r", b"a": b"\a", b"b": b"\b",
    b"f": b"\f", b"v": b"\v", b"\\": b"\\", b'"': b'"', b"'": b"'",
    b"\n": b"\n", b"0": b"\x00",
}


@dataclass
class _Tok:
    kind: str  # 'number' | 'name' | 'string' | 'op' | 'keyword' | 'eof'
    value: object
    pos: int


def _unescape(raw: bytes) -> bytes:
    out = bytearray()
    i = 0
    while i < len(raw):
        c = raw[i : i + 1]
        if c == b"\\" and i + 1 < len(raw):
            nxt = raw[i + 1 : i + 2]
            if nxt.isdigit():  # \ddd decimal escapes
                j = i + 1
                while j < len(raw) and j < i + 4 and raw[j : j + 1].isdigit():
                    j += 1
                out.append(int(raw[i + 1 : j]))
                i = j
                continue
            if nxt in _ESCAPES:
                out += _ESCAPES[nxt]
                i += 2
                continue
            raise LuaError(f"invalid escape sequence \\{nxt.decode(errors='replace')}")
        out += c
        i += 1
    return bytes(out)


def _tokenize(src: bytes) -> list[_Tok]:
    toks: list[_Tok] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise LuaError(f"unexpected character {src[pos:pos+1]!r} at byte {pos}")
        pos = m.end()
        if m.lastgroup in ("ws", "comment"):
            continue
        text = m.group()
        if m.lastgroup == "number":
            toks.append(_Tok("number", float(int(text, 16)) if text[:2].lower() == b"0x" else float(text), m.start()))
        elif m.lastgroup == "name":
            name = text.decode()
            toks.append(_Tok("keyword" if name in _KEYWORDS else "name", name, m.start()))
        elif m.lastgroup == "string":
            toks.append(_Tok("string", _unescape(text[1:-1]), m.start()))
        else:
            toks.append(_Tok("op", text.decode(), m.start()))
    toks.append(_Tok("eof", None, len(src)))
    return toks


# --------------------------------------------------------------------------
# Parser -> AST (tuples: (kind, ...))
# --------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: list[_Tok]):
        self.toks = toks
        self.i = 0

    @property
    def cur(self) -> _Tok:
        return self.toks[self.i]

    def _advance(self) -> _Tok:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _expect(self, kind: str, value=None) -> _Tok:
        t = self.cur
        if t.kind != kind or (value is not None and t.value != value):
            raise LuaError(f"expected {value or kind}, got {t.value!r} at byte {t.pos}")
        return self._advance()

    def _check(self, kind: str, value=None) -> bool:
        t = self.cur
        return t.kind == kind and (value is None or t.value == value)

    def _accept(self, kind: str, value=None) -> bool:
        if self._check(kind, value):
            self._advance()
            return True
        return False

    # --- statements -------------------------------------------------------

    def parse_chunk(self, *terminators: str) -> list:
        stats = []
        while True:
            t = self.cur
            if t.kind == "eof" or (t.kind == "keyword" and t.value in terminators):
                return stats
            if self._accept("op", ";"):
                continue
            stats.append(self._statement())
            if stats[-1][0] in ("return", "break"):
                # nothing may follow a laststat in a block
                t = self.cur
                if not (t.kind == "eof" or (t.kind == "keyword" and t.value in terminators)):
                    raise LuaError(f"unreachable statement after {stats[-1][0]} at byte {t.pos}")
                return stats

    def _statement(self):
        t = self.cur
        if t.kind == "keyword":
            if t.value == "local":
                self._advance()
                name = self._expect("name").value
                self._expect("op", "=")
                return ("local", name, self._expr())
            if t.value == "if":
                return self._if()
            if t.value == "for":
                return self._for()
            if t.value == "while":
                self._advance()
                cond = self._expr()
                self._expect("keyword", "do")
                body = self.parse_chunk("end")
                self._expect("keyword", "end")
                return ("while", cond, body)
            if t.value == "return":
                self._advance()
                u = self.cur
                if u.kind == "eof" or (u.kind == "keyword" and u.value in ("end", "else", "elseif", "until")):
                    return ("return", None)
                return ("return", self._expr())
            if t.value == "break":
                self._advance()
                return ("break",)
            if t.value == "do":
                self._advance()
                body = self.parse_chunk("end")
                self._expect("keyword", "end")
                return ("do", body)
            raise LuaError(f"unsupported statement '{t.value}' at byte {t.pos}")
        # expression statement: function call or assignment
        e = self._postfix_expr()
        if self._accept("op", "="):
            if e[0] not in ("name", "index"):
                raise LuaError(f"cannot assign to {e[0]} at byte {t.pos}")
            return ("assign", e, self._expr())
        if e[0] != "call":
            raise LuaError(f"expression is not a statement at byte {t.pos}")
        return e

    def _if(self):
        self._expect("keyword", "if")
        arms = []
        cond = self._expr()
        self._expect("keyword", "then")
        arms.append((cond, self.parse_chunk("elseif", "else", "end")))
        while self._check("keyword", "elseif"):
            self._advance()
            c = self._expr()
            self._expect("keyword", "then")
            arms.append((c, self.parse_chunk("elseif", "else", "end")))
        els = None
        if self._accept("keyword", "else"):
            els = self.parse_chunk("end")
        self._expect("keyword", "end")
        return ("if", arms, els)

    def _for(self):
        self._expect("keyword", "for")
        var = self._expect("name").value
        self._expect("op", "=")
        start = self._expr()
        self._expect("op", ",")
        stop = self._expr()
        step = None
        if self._accept("op", ","):
            step = self._expr()
        self._expect("keyword", "do")
        body = self.parse_chunk("end")
        self._expect("keyword", "end")
        return ("for", var, start, stop, step, body)

    # --- expressions (precedence climbing) ---------------------------------

    def _expr(self):
        return self._or()

    def _or(self):
        e = self._and()
        while self._check("keyword", "or"):
            self._advance()
            e = ("or", e, self._and())
        return e

    def _and(self):
        e = self._cmp()
        while self._check("keyword", "and"):
            self._advance()
            e = ("and", e, self._cmp())
        return e

    def _cmp(self):
        e = self._concat()
        while self.cur.kind == "op" and self.cur.value in ("==", "~=", "<", "<=", ">", ">="):
            op = self._advance().value
            e = ("binop", op, e, self._concat())
        return e

    def _concat(self):
        e = self._add()
        if self._check("op", ".."):
            self._advance()
            return ("binop", "..", e, self._concat())  # right-associative
        return e

    def _add(self):
        e = self._mul()
        while self.cur.kind == "op" and self.cur.value in ("+", "-"):
            op = self._advance().value
            e = ("binop", op, e, self._mul())
        return e

    def _mul(self):
        e = self._unary()
        while self.cur.kind == "op" and self.cur.value in ("*", "/", "%"):
            op = self._advance().value
            e = ("binop", op, e, self._unary())
        return e

    def _unary(self):
        t = self.cur
        if t.kind == "op" and t.value in ("#", "-"):
            self._advance()
            return ("unop", t.value, self._unary())
        if t.kind == "keyword" and t.value == "not":
            self._advance()
            return ("unop", "not", self._unary())
        return self._postfix_expr()

    def _postfix_expr(self):
        e = self._primary()
        while True:
            if self._accept("op", "["):
                idx = self._expr()
                self._expect("op", "]")
                e = ("index", e, idx)
            elif self._accept("op", "."):
                name = self._expect("name").value
                e = ("index", e, ("const", name.encode()))
            elif self._check("op", "("):
                self._advance()
                args = []
                if not self._check("op", ")"):
                    args.append(self._expr())
                    while self._accept("op", ","):
                        args.append(self._expr())
                self._expect("op", ")")
                e = ("call", e, args)
            else:
                return e

    def _primary(self):
        t = self.cur
        if t.kind == "number":
            self._advance()
            return ("const", t.value)
        if t.kind == "string":
            self._advance()
            return ("const", t.value)
        if t.kind == "keyword" and t.value in ("nil", "true", "false"):
            self._advance()
            return ("const", {"nil": None, "true": True, "false": False}[t.value])
        if t.kind == "name":
            self._advance()
            return ("name", t.value)
        if self._accept("op", "("):
            e = self._expr()
            self._expect("op", ")")
            return e
        if self._accept("op", "{"):
            items = []
            if not self._check("op", "}"):
                items.append(self._expr())
                while self._accept("op", ","):
                    if self._check("op", "}"):
                        break
                    items.append(self._expr())
            self._expect("op", "}")
            return ("table", items)
        raise LuaError(f"unexpected token {t.value!r} at byte {t.pos}")


def parse(src: bytes):
    """Parse a script; raises ``LuaError`` on any syntax error."""
    return _Parser(_tokenize(src)).parse_chunk()


# --------------------------------------------------------------------------
# Evaluator
# --------------------------------------------------------------------------


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


class LuaErrorReply:
    """``redis.error_reply(msg)``: converted to a RESP error on return."""

    def __init__(self, message: bytes):
        self.message = message


class LuaStatusReply:
    """``redis.status_reply(msg)``: converted to a RESP status on return."""

    def __init__(self, message: bytes):
        self.message = message


class LuaTable:
    """A Lua array-style table (1-based)."""

    def __init__(self, items: Optional[list] = None):
        self.items = list(items or [])

    def get(self, key):
        if isinstance(key, float) and key.is_integer():
            i = int(key)
            if 1 <= i <= len(self.items):
                return self.items[i - 1]
        return None

    def set(self, key, value):
        if not (isinstance(key, float) and key.is_integer()):
            raise LuaError("only integer table keys are supported")
        i = int(key)
        if i == len(self.items) + 1:
            self.items.append(value)
        elif 1 <= i <= len(self.items):
            self.items[i - 1] = value
        else:
            raise LuaError(f"sparse table assignment at index {i} is not supported")

    def __len__(self):
        return len(self.items)


def _truthy(v) -> bool:
    return v is not None and v is not False


def _type_name(v) -> str:
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, float):
        return "number"
    if isinstance(v, bytes):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    return "userdata"


def _num_to_lua_string(n: float) -> bytes:
    if n.is_integer():
        return b"%d" % int(n)
    return repr(n).encode()


def _tonumber(v) -> Optional[float]:
    if isinstance(v, float):
        return v
    if isinstance(v, bytes):
        try:
            return float(v.strip())
        except ValueError:
            return None
    return None


class _Env:
    def __init__(self, parent: Optional["_Env"] = None):
        self.vars: dict[str, object] = {}
        self.parent = parent

    def lookup(self, name: str):
        env = self
        while env is not None:
            if name in env.vars:
                return env.vars[name]
            env = env.parent
        raise LuaError(f"undefined variable '{name}'")

    def declare(self, name: str, value):
        self.vars[name] = value

    def assign(self, name: str, value):
        env = self
        while env is not None:
            if name in env.vars:
                env.vars[name] = value
                return
            env = env.parent
        raise LuaError(f"assignment to undeclared global '{name}' is not supported")


class _Interp:
    def __init__(self, globals_: dict[str, object]):
        self.root = _Env()
        self.root.vars.update(globals_)

    # --- statements -------------------------------------------------------

    def exec_block(self, stats: list, env: _Env) -> None:
        for st in stats:
            self.exec_stat(st, env)

    def exec_stat(self, st, env: _Env) -> None:
        kind = st[0]
        if kind == "local":
            env.declare(st[1], self.eval(st[2], env))
        elif kind == "assign":
            target, expr = st[1], st[2]
            value = self.eval(expr, env)
            if target[0] == "name":
                env.assign(target[1], value)
            else:  # index
                obj = self.eval(target[1], env)
                if not isinstance(obj, LuaTable):
                    raise LuaError(f"cannot index a {_type_name(obj)} value")
                obj.set(self.eval(target[2], env), value)
        elif kind == "if":
            for cond, body in st[1]:
                if _truthy(self.eval(cond, env)):
                    self.exec_block(body, _Env(env))
                    return
            if st[2] is not None:
                self.exec_block(st[2], _Env(env))
        elif kind == "for":
            _, var, start_e, stop_e, step_e, body = st
            start = self._want_number(self.eval(start_e, env), "'for' initial value")
            stop = self._want_number(self.eval(stop_e, env), "'for' limit")
            step = (
                self._want_number(self.eval(step_e, env), "'for' step")
                if step_e is not None
                else 1.0
            )
            if step == 0:
                raise LuaError("'for' step is zero")
            i = start
            try:
                while (step > 0 and i <= stop) or (step < 0 and i >= stop):
                    inner = _Env(env)
                    inner.declare(var, i)
                    self.exec_block(body, inner)
                    i += step
            except _Break:
                pass
        elif kind == "while":
            try:
                while _truthy(self.eval(st[1], env)):
                    self.exec_block(st[2], _Env(env))
            except _Break:
                pass
        elif kind == "do":
            self.exec_block(st[1], _Env(env))
        elif kind == "return":
            raise _Return(None if st[1] is None else self.eval(st[1], env))
        elif kind == "break":
            raise _Break()
        elif kind == "call":
            self.eval(st, env)
        else:  # pragma: no cover — parser only emits the kinds above
            raise LuaError(f"unknown statement kind {kind}")

    # --- expressions ------------------------------------------------------

    def eval(self, e, env: _Env):
        kind = e[0]
        if kind == "const":
            return e[1]
        if kind == "name":
            return env.lookup(e[1])
        if kind == "index":
            obj = self.eval(e[1], env)
            key = self.eval(e[2], env)
            if isinstance(obj, LuaTable):
                return obj.get(key)
            if isinstance(obj, dict):  # host namespace like `redis`
                name = key.decode() if isinstance(key, bytes) else key
                if name not in obj:
                    raise LuaError(f"unknown field '{name}'")
                return obj[name]
            raise LuaError(f"cannot index a {_type_name(obj)} value")
        if kind == "call":
            fn = self.eval(e[1], env)
            args = [self.eval(a, env) for a in e[2]]
            if not callable(fn):
                raise LuaError(f"cannot call a {_type_name(fn)} value")
            return fn(*args)
        if kind == "table":
            return LuaTable([self.eval(x, env) for x in e[1]])
        if kind == "and":
            left = self.eval(e[1], env)
            return self.eval(e[2], env) if _truthy(left) else left
        if kind == "or":
            left = self.eval(e[1], env)
            return left if _truthy(left) else self.eval(e[2], env)
        if kind == "unop":
            return self._unop(e[1], self.eval(e[2], env))
        if kind == "binop":
            return self._binop(e[1], self.eval(e[2], env), self.eval(e[3], env))
        raise LuaError(f"unknown expression kind {kind}")  # pragma: no cover

    @staticmethod
    def _want_number(v, what: str) -> float:
        n = _tonumber(v) if not isinstance(v, bool) else None
        if n is None:
            raise LuaError(f"{what} must be a number, got {_type_name(v)}")
        return n

    def _unop(self, op: str, v):
        if op == "#":
            if isinstance(v, bytes):
                return float(len(v))
            if isinstance(v, LuaTable):
                return float(len(v))
            raise LuaError(f"attempt to get length of a {_type_name(v)} value")
        if op == "-":
            return -self._want_number(v, "operand")
        if op == "not":
            return not _truthy(v)
        raise LuaError(f"unknown unary op {op}")  # pragma: no cover

    def _binop(self, op: str, a, b):
        if op in ("+", "-", "*", "/", "%"):
            x = self._want_number(a, "arithmetic operand")
            y = self._want_number(b, "arithmetic operand")
            if op == "+":
                return x + y
            if op == "-":
                return x - y
            if op == "*":
                return x * y
            if op == "/":
                if y == 0:
                    return float("inf") if x > 0 else float("-inf") if x < 0 else float("nan")
                return x / y
            return x - (x // y) * y if y != 0 else float("nan")  # Lua a%b
        if op == "..":
            parts = []
            for v in (a, b):
                if isinstance(v, bytes):
                    parts.append(v)
                elif isinstance(v, float):
                    parts.append(_num_to_lua_string(v))
                else:
                    raise LuaError(f"attempt to concatenate a {_type_name(v)} value")
            return parts[0] + parts[1]
        if op == "==":
            return self._lua_eq(a, b)
        if op == "~=":
            return not self._lua_eq(a, b)
        # ordering: number-number or string-string only (Lua 5.1 semantics)
        if isinstance(a, float) and isinstance(b, float):
            pass
        elif isinstance(a, bytes) and isinstance(b, bytes):
            pass
        else:
            raise LuaError(f"attempt to compare {_type_name(a)} with {_type_name(b)}")
        if op == "<":
            return a < b
        if op == "<=":
            return a <= b
        if op == ">":
            return a > b
        if op == ">=":
            return a >= b
        raise LuaError(f"unknown binary op {op}")  # pragma: no cover

    @staticmethod
    def _lua_eq(a, b) -> bool:
        # different types are never equal (no coercion in ==)
        if _type_name(a) != _type_name(b):
            return False
        if isinstance(a, LuaTable):
            return a is b
        return a == b


# --------------------------------------------------------------------------
# Redis EVAL front door
# --------------------------------------------------------------------------


def _from_redis(value):
    """RESP reply -> Lua value (Redis EVAL conversion rules)."""
    if value is None:
        return False  # RESP nil becomes Lua false
    if isinstance(value, int):
        return float(value)
    if isinstance(value, (bytes, bytearray)):
        return bytes(value)
    if isinstance(value, str):
        return value.encode()
    if isinstance(value, (list, tuple)):
        return LuaTable([_from_redis(v) for v in value])
    if isinstance(value, float):
        # Redis never returns floats from commands; scores arrive as strings
        return _num_to_lua_string(value)
    raise LuaError(f"unsupported redis reply type {type(value).__name__}")


def to_redis(value):
    """Lua value -> RESP reply (Redis EVAL conversion rules).

    An error reply raises ``LuaError`` so the RESP layer sends a ``-ERR``;
    a status reply becomes its message (the fake encodes bytes as bulk,
    which the client reads equivalently to a simple status here).
    """
    if isinstance(value, LuaErrorReply):
        raise LuaError(value.message.decode(errors="replace"))
    if isinstance(value, LuaStatusReply):
        return value.message
    if value is None or value is False:
        return None
    if value is True:
        return 1
    if isinstance(value, float):
        return int(value)  # truncation, as Redis does
    if isinstance(value, bytes):
        return value
    if isinstance(value, LuaTable):
        out = []
        for v in value.items:
            if v is None or v is False:
                break  # a nil ends the array, per Redis conversion rules
            out.append(to_redis(v))
        return out
    raise LuaError(f"unsupported return type {_type_name(value)}")


def run_script(
    script: bytes,
    keys: list[bytes],
    argv: list[bytes],
    call: Callable[..., object],
) -> object:
    """Execute ``script`` with ``KEYS``/``ARGV`` bound and ``redis.call`` -> ``call``.

    ``call`` receives the command arguments as bytes and returns a RESP-style
    value (int, bytes, None, or list). The return value is converted with the
    EVAL conversion rules (``to_redis``). Raises ``LuaError`` on syntax or
    runtime errors — including errors raised by ``call`` itself (as
    ``redis.call`` does; ``redis.pcall`` would catch them, and is mapped to
    the same host function since the scripts here never rely on catching).
    """
    ast = parse(script)

    def lua_call(*args):
        if not args:
            raise LuaError("redis.call needs at least one argument")
        cmd_args = []
        for a in args:
            if isinstance(a, bytes):
                cmd_args.append(a)
            elif isinstance(a, float):
                cmd_args.append(_num_to_lua_string(a))
            else:
                raise LuaError(
                    f"redis.call argument must be a string or number, got {_type_name(a)}"
                )
        return _from_redis(call(*cmd_args))

    def lua_tonumber(v, base=None):
        if base is not None:
            if not isinstance(v, bytes):
                return None
            try:
                return float(int(v, int(base)))
            except ValueError:
                return None
        return _tonumber(v)

    def lua_tostring(v):
        if isinstance(v, bytes):
            return v
        if isinstance(v, float):
            return _num_to_lua_string(v)
        if v is None:
            return b"nil"
        if isinstance(v, bool):
            return b"true" if v else b"false"
        return _type_name(v).encode()

    interp = _Interp(
        {
            "KEYS": LuaTable(list(keys)),
            "ARGV": LuaTable(list(argv)),
            "redis": {
                "call": lua_call,
                "pcall": lua_call,
                "error_reply": lambda msg: LuaErrorReply(msg),
                "status_reply": lambda msg: LuaStatusReply(msg),
            },
            "tonumber": lua_tonumber,
            "tostring": lua_tostring,
        }
    )
    try:
        interp.exec_block(ast, _Env(interp.root))
    except _Return as r:
        return to_redis(r.value)
    except _Break:
        raise LuaError("break outside of a loop")
    return None
