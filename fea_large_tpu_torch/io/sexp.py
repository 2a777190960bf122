"""S-expression task-file support (a copy of `fea_large_tpu/io/sexp.py`,
pure Python, pinned by tests against it).

Task files may also be S-expressions: an sexp of nested `(key value ...)`
pairs is converted to the same dict schema that `io.task` consumes from
JSON/TOML, so

    (task
      (mesh (box (nx 4) (ny 4) (nz 4)))
      (element-type tet10)
      (material (model neo-hookean) (E 1.0) (nu 0.3))
      (loading
        (n-steps 4)
        (dirichlet (set zmin) (components xyz) (value 0.0))
        (dirichlet (set zmax) (components z) (value -0.3)))
      (solver (linear pcg) (pcg-tol 1e-12)))

loads like the equivalent JSON task. Keys use lisp-style dashes
(converted to underscores); repeated keys (e.g. `dirichlet`) accumulate
into lists.
"""

from __future__ import annotations

import pathlib

_LIST_KEYS = {"dirichlet", "forces"}


def tokenize(text: str):
    out = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c == ";":  # comment to end of line
            while i < n and text[i] != "\n":
                i += 1
        elif c in "()":
            out.append(c)
            i += 1
        elif c.isspace():
            i += 1
        elif c == '"':
            j = i + 1
            while j < n and text[j] != '"':
                j += 1
            out.append(text[i + 1 : j])
            i = j + 1
        else:
            j = i
            while j < n and not text[j].isspace() and text[j] not in '();"':
                j += 1
            out.append(_atom(text[i:j]))
            i = j
    return out


def _atom(tok: str):
    for cast in (int, float):
        try:
            return cast(tok)
        except ValueError:
            pass
    return tok


def parse(tokens):
    """One sexp from a token stream -> nested Python lists/atoms."""
    tok = tokens.pop(0)
    if tok == "(":
        out = []
        while tokens[0] != ")":
            out.append(parse(tokens))
        tokens.pop(0)
        return out
    if tok == ")":
        raise ValueError("unexpected )")
    return tok


def _key(k) -> str:
    return str(k).replace("-", "_")


def to_dict(sx):
    """Convert a `(key value...)`-style sexp tree to the task dict schema."""
    if not isinstance(sx, list):
        return sx
    if all(not isinstance(x, list) for x in sx):
        # leaf list: (key atom) -> value; (key a b c) -> [a, b, c]
        if len(sx) == 2:
            return {_key(sx[0]): sx[1]}
        return {_key(sx[0]): list(sx[1:])}
    key = _key(sx[0])
    body = {}
    for item in sx[1:]:
        if isinstance(item, list):
            k = _key(item[0])
            v = to_dict(item)
            v = v[k] if isinstance(v, dict) and set(v) == {k} else v
            if k in _LIST_KEYS:
                body.setdefault(k, []).append(v)
            else:
                body[k] = v
        else:
            body.setdefault("_args", []).append(item)
    return {key: body}


def load_sexp_task_dict(path) -> dict:
    """Read a `.sexp`/`.task` file and return the JSON-schema task dict."""
    text = pathlib.Path(path).read_text()
    tree = parse(tokenize(text))
    d = to_dict(tree)
    if set(d) == {"task"}:
        d = d["task"]
    # vectors: forces use (vector x y z)
    for f in d.get("loading", {}).get("forces", []):
        if isinstance(f.get("vector"), dict):
            f["vector"] = list(f["vector"].values())
    return d
