"""Fleet /metrics federation: relabel replica scrapes for the router.

The ingress router exposes one `/metrics` that appends every replica's
scrape with a `replica="host:port"` label injected into each sample, so
a single Prometheus target sees the whole fleet (the federation shape
Knative gets from per-pod scrape configs).  The rewriter must survive
label values containing braces/quotes and OpenMetrics exemplar
suffixes, so it scans the label block character-wise instead of
regexing the line.
"""

from typing import Dict, List, Optional, Tuple

from kfserving_tpu_torch.observability.registry import escape_label_value


def split_sample(line: str) -> Optional[Tuple[str, str, str]]:
    """Split a sample line into (name, label_block_inner, rest).

    `rest` is everything after the label block (value, and any
    exemplar suffix), leading space stripped.  Returns None for lines
    that are not samples (comments, blanks, malformed)."""
    line = line.rstrip()
    if not line or line.startswith("#"):
        return None
    brace = line.find("{")
    space = line.find(" ")
    if brace == -1 or (space != -1 and space < brace):
        if space == -1:
            return None
        return line[:space], "", line[space + 1:].lstrip()
    name = line[:brace]
    i = brace + 1
    in_quotes = False
    escaped = False
    while i < len(line):
        c = line[i]
        if escaped:
            escaped = False
        elif c == "\\":
            escaped = True
        elif c == '"':
            in_quotes = not in_quotes
        elif c == "}" and not in_quotes:
            return name, line[brace + 1:i], line[i + 1:].lstrip()
        i += 1
    return None


def relabel(text: str, extra: Dict[str, str],
            seen_meta: Optional[set] = None,
            keep_exemplars: bool = True) -> List[str]:
    """Rewrite a /metrics payload, injecting `extra` labels into every
    sample line.  # HELP / # TYPE lines pass through once per metric
    name across calls (share `seen_meta` between replicas so the
    merged output never re-declares a family).  ``keep_exemplars=
    False`` strips OpenMetrics exemplar suffixes — required when the
    merged output is served as classic text/plain, whose parser
    rejects them."""
    prefix = ",".join(f'{k}="{escape_label_value(v)}"'
                      for k, v in sorted(extra.items()))
    out: List[str] = []
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            if seen_meta is not None:
                parts = line.split(" ", 3)
                key = (parts[1], parts[2]) if len(parts) > 2 else line
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            out.append(line)
            continue
        parsed = split_sample(line)
        if parsed is None:
            continue
        name, inner, rest = parsed
        if not keep_exemplars:
            # `rest` is "<value> [# {exemplar} v ts]"; the value itself
            # never contains " # ".
            rest = rest.split(" # ", 1)[0]
        labels = prefix + ("," + inner if inner else "")
        out.append(f"{name}{{{labels}}} {rest}")
    return out


def merge_scrapes(own_lines: List[str],
                  scrapes: List[Tuple[str, str]],
                  keep_exemplars: bool = True) -> List[str]:
    """Merge the router's own exposition with replica scrapes into ONE
    valid payload: every family declared exactly once, with ALL of its
    samples (own + every replica's, relabeled) contiguous under the
    declaration — the shape strict OpenMetrics parsers require (a
    naive concatenation re-declares shared families per replica, and a
    TYPE-deduped concatenation scatters a family's samples, both of
    which abort the whole scrape).

    In-process deployments share one registry between router and
    replicas, so shared series appear both bare and replica-labeled —
    a dev-mode artifact; subprocess replicas have disjoint registries.
    """
    # family name -> {"meta": [...], "samples": [...]}; insertion order
    # is emission order.
    families: Dict[str, Dict[str, List[str]]] = {}
    seen_meta: set = set()

    def feed(lines: List[str]):
        current = None
        for line in lines:
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                # "# HELP <name> <text>" / "# TYPE <name> <kind>"
                parts = line.split(" ", 3)
                if len(parts) < 3:
                    continue
                kind, current = parts[1], parts[2]
                fam = families.setdefault(current,
                                          {"meta": [], "samples": []})
                if (current, kind) not in seen_meta:
                    seen_meta.add((current, kind))
                    fam["meta"].append(line)
                continue
            parsed = split_sample(line)
            if parsed is None:
                continue
            name = parsed[0]
            # Histogram _bucket/_sum/_count samples group under their
            # declared base family; anything else is its own family.
            fam_name = (current if current is not None
                        and name.startswith(current) else name)
            families.setdefault(fam_name,
                                {"meta": [], "samples": []})[
                "samples"].append(line)

    feed(own_lines)
    for host, text in scrapes:
        feed(relabel(text, {"replica": host},
                     keep_exemplars=keep_exemplars))
    out: List[str] = []
    for fam in families.values():
        out += fam["meta"]
        out += fam["samples"]
    return out
