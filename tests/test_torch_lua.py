"""The port's Lua runner (``xaynet_tpu_torch.utils.lua_mini``) against the
JAX package's.

Every script of both storage modules and the corpus of
``tests/test_lua_mini.py`` run through both interpreters: the replies, the
Redis state the scripts leave and the ``LuaError`` cases (raised at parse
or at run time, with the same message) must be the same. Tolerance zero.
"""

from __future__ import annotations

import re

import pytest
from redis_commands import DictRedisCommands

from xaynet_tpu.storage import redis as jax_redis
from xaynet_tpu.utils import lua_mini as jax_lua

from xaynet_tpu_torch.storage import redis as port_redis
from xaynet_tpu_torch.utils import lua_mini as port_lua

SCRIPTS = ("ADD_SUM_PARTICIPANT", "ADD_LOCAL_SEED_DICT", "INCR_MASK_SCORE")


def _boom(*parts):
    raise port_lua.LuaError("WRONGTYPE")


def _boom_jax(*parts):
    raise jax_lua.LuaError("WRONGTYPE")


# host ``redis.call`` handlers by name: (the port's, the JAX package's)
CALLS = {
    "none": (lambda *a: None, lambda *a: None),
    "ok": (lambda *a: b"OK", lambda *a: b"OK"),
    "boom": (_boom, _boom_jax),
}

# (source, ARGV, call handler): tests/test_lua_mini.py's programs, and more
RUNS = {
    "truncating-division": ("return 7 / 2", (), "none"),
    "argv-first": ("return ARGV[1]", (b"first", b"second"), "none"),
    "argv-length": ("return #ARGV", (b"a", b"b", b"c"), "none"),
    "argv-last": ("return ARGV[#ARGV]", (b"a", b"z"), "none"),
    "out-of-range-nil": ("if ARGV[5] == nil then return 1 end return 0", (b"x",), "none"),
    "number-string-eq": ('if 1 == "1" then return 1 end return 0', (), "none"),
    "number-string-ne": ('if 1 ~= "1" then return 1 end return 0', (), "none"),
    "and-operand": ("return 0 and 2", (), "none"),
    "or-operand": ("return nil or 7", (), "none"),
    "false-or-nil": ("return false or nil", (), "none"),
    "for-step": (
        "local acc = 0\nfor i = 2, #ARGV, 2 do\n  acc = acc + tonumber(ARGV[i])\nend\nreturn acc",
        (b"9", b"1", b"9", b"2", b"9", b"3"), "none",
    ),
    "for-descending-break": (
        "local n = 0\nfor i = 10, 1, -1 do\n  n = n + 1\n  if i == 8 then break end\nend\n"
        "return n", (), "none",
    ),
    "while": ("local i = 0\nwhile i < 5 do\n  i = i + 1\nend\nreturn i", (), "none"),
    "concat-number": ('return "seed_dict:" .. 42', (), "none"),
    "concat-argv": ("return ARGV[1] .. ARGV[2]", (b"ab", b"cd"), "none"),
    "string-arithmetic": ('return "4" + 1', (), "none"),
    "modulo": ("return -3 % 5", (), "none"),
    "comments-escapes": ('-- leading comment\nreturn "a\\"b" -- trailing', (), "none"),
    "shadowing": ("local x = 1\nif true then\n  local x = 2\nend\nreturn x", (), "none"),
    "table": ('local t = {}\nt[1] = "a"\nt[2] = "b"\nreturn #t', (), "none"),
    "table-return": ('return {1, "a", nil, 2}', (), "none"),
    "float-return": ("return 3.9", (), "none"),
    "bool-return": ("return true", (), "none"),
    "elseif": (
        "local v = tonumber(ARGV[1])\nif v < 0 then return -1 elseif v == 0 then return 0 "
        "else return 1 end", (b"0",), "none",
    ),
    "tostring": ("return tostring(12) .. ARGV[1]", (b"!",), "none"),
    "nil-reply-is-false": ('if redis.call("GET", "k") == false then return 1 end return 0',
                           (), "none"),
    "status-passthrough": ('return redis.call("SET", "k", "v")', (), "ok"),
    "status-reply": ('return redis.status_reply("OK")', (), "none"),
    "pcall-error": ('local r = redis.pcall("GET", "k")\nreturn 1', (), "boom"),
    # the LuaError cases, at parse time and at run time
    "missing-end": ("if 1 == 1 then return 1", (), "none"),
    "bad-operator": ("return 1 != 2", (), "none"),
    "code-after-return": ("return 1\nlocal x = 2", (), "none"),
    "undefined-variable": ("return undefined_thing", (), "none"),
    "number-lt-string": ('return 1 < "2"', (), "none"),
    "function-unsupported": ("local function f() return 1 end return f()", (), "none"),
    "call-error": ('return redis.call("GET", "k")', (), "boom"),
    "error-reply": ('return redis.error_reply("wrong state")', (), "none"),
    "goto-unsupported": ("goto done", (), "none"),
    "mutated-script": (jax_redis.ADD_LOCAL_SEED_DICT.replace(b"then", b"thn", 1).decode(),
                       (), "none"),
}  # fmt: skip


def _outcome(lua, src: str, argv, call):
    try:
        return ("reply", lua.run_script(src.encode(), [b"k1"], list(argv), call))
    except lua.LuaError as err:
        return ("LuaError", str(err))


@pytest.mark.parametrize("case", list(RUNS))
def test_both_interpreters_give_the_same_outcome(case):
    src, argv, call = RUNS[case]
    ours, theirs = CALLS[call]
    got = _outcome(port_lua, src, argv, ours)
    want = _outcome(jax_lua, src, argv, theirs)
    assert got == want
    # the port parses what the JAX package parses, and refuses the same
    try:
        jax_lua.parse(src.encode())
    except jax_lua.LuaError as err:
        with pytest.raises(port_lua.LuaError, match="^" + re.escape(str(err)) + "$"):
            port_lua.parse(src.encode())
    else:
        assert port_lua.parse(src.encode())


CONVERSIONS = {
    "nil": (None, None),
    "false": (False, None),
    "true": (True, 1),
    "float": (3.9, 3),
    "negative-float": (-3.9, -3),
    "bytes": (b"x", b"x"),
    "table-ends-at-nil": ("table", [1, b"a"]),
}


@pytest.mark.parametrize("case", list(CONVERSIONS))
def test_redis_conversions_match(case):
    value, want = CONVERSIONS[case]
    if value == "table":
        got = port_lua.to_redis(port_lua.LuaTable([1.0, b"a", None, 2.0]))
        theirs = jax_lua.to_redis(jax_lua.LuaTable([1.0, b"a", None, 2.0]))
    else:
        got, theirs = port_lua.to_redis(value), jax_lua.to_redis(value)
    assert got == theirs == want


def _state(store: DictRedisCommands) -> tuple:
    return store.hashes, store.sets, store.zsets


SEQUENCES = {
    # (script, KEYS, ARGV) steps from one initial state
    "sum-participants": [
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"pk1", b"ephm1"]),
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"pk1", b"other"]),
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"pk2", b"ephm2"]),
    ],
    "seed-dict-codes": [
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"s1", b"e1"]),
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"s2", b"e2"]),
        ("ADD_LOCAL_SEED_DICT", [b"sum_dict", b"update_participants", b"seed_dict:"],
         [b"u1", b"s1", b"seed-1"]),
        ("ADD_LOCAL_SEED_DICT", [b"sum_dict", b"update_participants", b"seed_dict:"],
         [b"u1", b"s1", b"seed-1", b"nope", b"seed-x"]),
        ("ADD_LOCAL_SEED_DICT", [b"sum_dict", b"update_participants", b"seed_dict:"],
         [b"u1", b"s1", b"seed-1", b"s2", b"seed-2"]),
        ("ADD_LOCAL_SEED_DICT", [b"sum_dict", b"update_participants", b"seed_dict:"],
         [b"u1", b"s1", b"seed-1", b"s2", b"seed-2"]),
        ("ADD_LOCAL_SEED_DICT", [b"sum_dict", b"update_participants", b"seed_dict:"],
         [b"u2", b"s2", b"seed-3", b"s1", b"seed-4"]),
    ],
    "seed-dict-partial-submission": [
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"s1", b"e1"]),
        ("ADD_LOCAL_SEED_DICT", [b"sum_dict", b"upd", b"t:a:seed_dict:"],
         [b"u1", b"s1", b"old"]),
        ("ADD_LOCAL_SEED_DICT", [b"sum_dict", b"upd-fresh", b"t:a:seed_dict:"],
         [b"u1", b"s1", b"new"]),
    ],
    "mask-scores": [
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"s1", b"e1"]),
        ("ADD_SUM_PARTICIPANT", [b"sum_dict"], [b"s2", b"e2"]),
        ("INCR_MASK_SCORE", [b"sum_dict", b"mask_submitted", b"mask_dict"],
         [b"intruder", b"mask-a"]),
        ("INCR_MASK_SCORE", [b"sum_dict", b"mask_submitted", b"mask_dict"], [b"s1", b"mask-a"]),
        ("INCR_MASK_SCORE", [b"sum_dict", b"mask_submitted", b"mask_dict"], [b"s1", b"mask-a"]),
        ("INCR_MASK_SCORE", [b"sum_dict", b"mask_submitted", b"mask_dict"], [b"s2", b"mask-a"]),
    ],
}  # fmt: skip


@pytest.mark.parametrize("case", list(SEQUENCES))
def test_storage_scripts_leave_the_same_state(case):
    """The three scripts of each package's ``storage/redis.py`` are the same
    text, and a sequence of them leaves the same replies and the same
    hashes, sets and sorted sets in each interpreter."""
    for name in SCRIPTS:
        assert getattr(port_redis, name) == getattr(jax_redis, name)
        assert port_lua.parse(getattr(port_redis, name))
    ours, theirs = DictRedisCommands(), DictRedisCommands()
    for name, keys, argv in SEQUENCES[case]:
        got = port_lua.run_script(getattr(port_redis, name), keys, argv, ours)
        want = jax_lua.run_script(getattr(jax_redis, name), keys, argv, theirs)
        assert got == want
    assert _state(ours) == _state(theirs)
