"""Rule SQL dialect: lexer + recursive-descent parser. The port's copy of
`emqx_tpu/rules/sql.py`, unchanged below this docstring: the rule
compiler (`rules/compile.py`) tests ``isinstance`` against these AST
classes, so it parses with its own.

Grammar (the subset of the reference's rulesql grammar that its docs and
test suites exercise, emqx_rule_sqlparser.erl:52-55):

    query    := SELECT selects FROM topics [WHERE expr]
              | FOREACH expr [AS ident] [DO selects] [INCASE expr]
                FROM topics [WHERE expr]
    selects  := '*' | sel (',' sel)*
    sel      := expr [AS dotted_ident]
    topics   := string (',' string)*
    expr     := disjunction of conjunctions of comparisons over
                + - * / div mod, unary -, function calls, dotted/indexed
                access (payload.a.b, arr[1]), literals, CASE WHEN

Keywords are case-insensitive; identifiers are case-sensitive. String
literals take single or double quotes (the reference uses double quotes
for FROM topics, single for strings).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


class SqlParseError(Exception):
    pass


# -- AST ---------------------------------------------------------------------

@dataclass
class Lit:
    value: object


@dataclass
class Var:
    path: List[object]  # mixed str keys / int indices; ["payload","x"]


@dataclass
class Call:
    name: str
    args: List[object]


@dataclass
class BinOp:
    op: str
    left: object
    right: object


@dataclass
class UnOp:
    op: str  # 'not' | 'neg'
    operand: object


@dataclass
class InList:
    needle: object
    items: List[object]
    negated: bool = False


@dataclass
class Case:
    whens: List[Tuple[object, object]]
    default: Optional[object] = None


@dataclass
class SelectItem:
    expr: object
    alias: Optional[List[str]] = None  # dotted alias path


@dataclass
class Query:
    selects: Optional[List[SelectItem]]  # None => SELECT *
    topics: List[str]
    where: Optional[object] = None
    # FOREACH parts
    foreach: Optional[object] = None
    foreach_alias: Optional[str] = None
    incase: Optional[object] = None


# -- lexer -------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<num>\d+\.\d+|\d+)
  | (?P<str>'(?:[^'\\]|\\.)*'|"(?:[^"\\]|\\.)*")
  | (?P<op><>|!=|>=|<=|=|>|<|\+|-|\*|/|\(|\)|\[|\]|,|\.)
  | (?P<ident>[A-Za-z_$][A-Za-z0-9_$]*)
    """,
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "from", "where", "as", "and", "or", "not", "in", "div",
    "mod", "foreach", "do", "incase", "case", "when", "then", "else",
    "end", "true", "false", "null", "like",
}


def _lex(text: str) -> List[Tuple[str, object]]:
    out: List[Tuple[str, object]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise SqlParseError(f"bad character {text[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        tok = m.group()
        if kind == "ws":
            continue
        if kind == "num":
            out.append(("num", float(tok) if "." in tok else int(tok)))
        elif kind == "str":
            body = tok[1:-1]
            body = re.sub(r"\\(.)", r"\1", body)
            out.append(("str", body))
        elif kind == "ident":
            low = tok.lower()
            if low in _KEYWORDS:
                out.append(("kw", low))
            else:
                out.append(("ident", tok))
        else:
            out.append(("op", tok))
    out.append(("eof", None))
    return out


# -- parser ------------------------------------------------------------------

class _Parser:
    def __init__(self, toks: List[Tuple[str, object]]):
        self.toks = toks
        self.i = 0

    def peek(self) -> Tuple[str, object]:
        return self.toks[self.i]

    def next(self) -> Tuple[str, object]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str, val=None):
        k, v = self.next()
        if k != kind or (val is not None and v != val):
            raise SqlParseError(f"expected {val or kind}, got {v!r}")
        return v

    def accept_kw(self, word: str) -> bool:
        k, v = self.peek()
        if k == "kw" and v == word:
            self.i += 1
            return True
        return False

    # query := SELECT ... | FOREACH ...
    def parse_query(self) -> Query:
        if self.accept_kw("select"):
            selects = self.parse_selects()
            q = Query(selects=selects, topics=[])
        elif self.accept_kw("foreach"):
            fe = self.parse_expr()
            alias = None
            if self.accept_kw("as"):
                alias = self.expect("ident")
            selects = None
            if self.accept_kw("do"):
                selects = self.parse_selects()
            incase = None
            if self.accept_kw("incase"):
                incase = self.parse_expr()
            q = Query(
                selects=selects,
                topics=[],
                foreach=fe,
                foreach_alias=alias,
                incase=incase,
            )
        else:
            raise SqlParseError("query must start with SELECT or FOREACH")
        self.expect("kw", "from")
        q.topics = [self.expect("str")]
        while self.peek() == ("op", ","):
            self.next()
            q.topics.append(self.expect("str"))
        if self.accept_kw("where"):
            q.where = self.parse_expr()
        if self.peek()[0] != "eof":
            raise SqlParseError(f"trailing input at token {self.peek()!r}")
        return q

    def parse_selects(self) -> Optional[List[SelectItem]]:
        if self.peek() == ("op", "*"):
            self.next()
            return None
        items = [self.parse_select_item()]
        while self.peek() == ("op", ","):
            self.next()
            items.append(self.parse_select_item())
        return items

    def parse_select_item(self) -> SelectItem:
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = [self.expect("ident")]
            while self.peek() == ("op", "."):
                self.next()
                alias.append(self.expect("ident"))
        return SelectItem(expr=e, alias=alias)

    # precedence climb: or > and > not > cmp > add > mul > unary > postfix
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_and()
        while self.accept_kw("or"):
            left = BinOp("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.accept_kw("and"):
            left = BinOp("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept_kw("not"):
            return UnOp("not", self.parse_not())
        return self.parse_cmp()

    def parse_cmp(self):
        left = self.parse_add()
        k, v = self.peek()
        if k == "op" and v in ("=", "!=", "<>", ">", "<", ">=", "<="):
            self.next()
            op = "!=" if v == "<>" else v
            return BinOp(op, left, self.parse_add())
        negated = False
        save = self.i
        if self.accept_kw("not"):
            if self.peek() == ("kw", "in"):
                negated = True
            else:
                self.i = save
                return left
        if self.accept_kw("in"):
            self.expect("op", "(")
            items = [self.parse_expr()]
            while self.peek() == ("op", ","):
                self.next()
                items.append(self.parse_expr())
            self.expect("op", ")")
            return InList(left, items, negated)
        if self.accept_kw("like"):
            pat = self.expect("str")
            # SQL LIKE: % = any run, _ = one char
            rx = re.escape(pat).replace("%", ".*").replace("_", ".")
            return Call("regex_match", [left, Lit(f"^{rx}$")])
        return left

    def parse_add(self):
        left = self.parse_mul()
        while True:
            k, v = self.peek()
            if k == "op" and v in ("+", "-"):
                self.next()
                left = BinOp(v, left, self.parse_mul())
            else:
                return left

    def parse_mul(self):
        left = self.parse_unary()
        while True:
            k, v = self.peek()
            if (k == "op" and v in ("*", "/")) or (
                k == "kw" and v in ("div", "mod")
            ):
                self.next()
                left = BinOp(v, left, self.parse_unary())
            else:
                return left

    def parse_unary(self):
        if self.peek() == ("op", "-"):
            self.next()
            return UnOp("neg", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            k, v = self.peek()
            if (k, v) == ("op", "."):
                self.next()
                nk, nv = self.next()
                if nk not in ("ident", "kw"):
                    raise SqlParseError(f"bad attribute {nv!r}")
                if isinstance(e, Var):
                    e = Var(e.path + [str(nv)])
                else:
                    e = Call("map_get", [Lit(str(nv)), e])
            elif (k, v) == ("op", "["):
                self.next()
                idx = self.parse_expr()
                self.expect("op", "]")
                if isinstance(e, Var) and isinstance(idx, Lit):
                    e = Var(e.path + [idx.value])
                else:
                    e = Call("nth", [idx, e])
            else:
                return e

    def parse_primary(self):
        k, v = self.next()
        if k == "num" or k == "str":
            return Lit(v)
        if k == "kw":
            if v == "true":
                return Lit(True)
            if v == "false":
                return Lit(False)
            if v == "null":
                return Lit(None)
            if v == "case":
                return self.parse_case()
            raise SqlParseError(f"unexpected keyword {v!r}")
        if k == "ident":
            if self.peek() == ("op", "("):
                self.next()
                args = []
                if self.peek() != ("op", ")"):
                    args.append(self.parse_expr())
                    while self.peek() == ("op", ","):
                        self.next()
                        args.append(self.parse_expr())
                self.expect("op", ")")
                return Call(v.lower(), args)
            return Var([v])
        if (k, v) == ("op", "("):
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        raise SqlParseError(f"unexpected token {v!r}")

    def parse_case(self) -> Case:
        whens = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect("kw", "then")
            whens.append((cond, self.parse_expr()))
        default = None
        if self.accept_kw("else"):
            default = self.parse_expr()
        self.expect("kw", "end")
        if not whens:
            raise SqlParseError("CASE needs at least one WHEN")
        return Case(whens, default)


def parse_sql(text: str) -> Query:
    return _Parser(_lex(text)).parse_query()
