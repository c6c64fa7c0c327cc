"""Minimal Prometheus text-format metrics registry.

No client library dependency: a registry of counters, gauges and
histograms whose ``render()`` emits text exposition format 0.0.4 —
what ``repro_torch.service``'s ``/metrics`` endpoint serves and what CI's
strict ``parse_promtext`` checker re-reads.  Histograms are backed by
the service layer's ``LatencySketch`` (bounded log-bucket memory,
exact-associative merge) with a *coarse* growth factor: Prometheus
buckets are cumulative ``le`` lines in the scrape body, so ~20 buckets
(growth 2.0 over 1ms–1h) beats the sketch's quantile-grade ~450.

Metric names must match ``[a-zA-Z_:][a-zA-Z0-9_:]*``; labels are
passed as a dict and serialized sorted, so a (name, labels) pair is a
stable series identity.
"""
from __future__ import annotations

import math
import re
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

if TYPE_CHECKING:                       # pragma: no cover
    from repro_torch.service.slo import LatencySketch

# The sketch import is deferred to first use: repro_torch.service's package
# init pulls in the fleet executor, and the executor imports repro_torch.obs
# — a module-level import here would close that cycle.


def _make_sketch(lo: float, hi: float, growth: float):
    from repro_torch.service.slo import LatencySketch
    return LatencySketch(lo, hi, growth)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers bare, +Inf spelled."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    if v != v:                      # NaN
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _labelstr(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace(
            '"', r"\"").replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _series_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    def __init__(self, name: str, help_: str, kind: str) -> None:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help_
        self.kind = kind
        self._series: Dict[Tuple, object] = {}

    def _get(self, labels: Dict[str, str], mk):
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        key = _series_key(labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = mk()
        return s

    def _header(self) -> List[str]:
        lines = []
        if self.help:
            esc = self.help.replace("\\", r"\\").replace("\n", r"\n")
            lines.append(f"# HELP {self.name} {esc}")
        lines.append(f"# TYPE {self.name} {self.kind}")
        return lines


class Counter(_Metric):
    def __init__(self, name: str, help_: str = "") -> None:
        super().__init__(name, help_, "counter")

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        key = _series_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(_series_key(labels), 0.0))

    def render(self) -> List[str]:
        lines = self._header()
        for key, v in sorted(self._series.items()):
            lines.append(f"{self.name}{_labelstr(dict(key))} {_fmt(v)}")
        return lines


class Gauge(_Metric):
    def __init__(self, name: str, help_: str = "") -> None:
        super().__init__(name, help_, "gauge")

    def set(self, value: float, **labels) -> None:
        self._series[_series_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _series_key(labels)
        self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(_series_key(labels), 0.0))

    def render(self) -> List[str]:
        lines = self._header()
        for key, v in sorted(self._series.items()):
            lines.append(f"{self.name}{_labelstr(dict(key))} {_fmt(v)}")
        return lines


class Histogram(_Metric):
    """Cumulative-bucket histogram over a coarse ``LatencySketch``.

    The sketch's geometric buckets become Prometheus ``le`` bounds; the
    exposition is cumulative per the format, and ``le="+Inf"`` always
    equals ``_count``.  ``observe()`` takes seconds (the Prometheus
    base-unit convention)."""

    def __init__(self, name: str, help_: str = "", *,
                 lo: float = 1e-3, hi: float = 3600.0,
                 growth: float = 2.0) -> None:
        super().__init__(name, help_, "histogram")
        self._geometry = (lo, hi, growth)

    def observe(self, seconds: float, **labels) -> None:
        lo, hi, growth = self._geometry
        sk = self._get(labels, lambda: _make_sketch(lo, hi, growth))
        sk.add(max(0.0, seconds))

    def sketch(self, **labels) -> Optional["LatencySketch"]:
        return self._series.get(_series_key(labels))

    def absorb(self, sketch: "LatencySketch", **labels) -> None:
        """Merge a foreign sketch (e.g. a run's SLO sketch) into this
        series.  Matching geometry merges exactly; a finer foreign
        sketch is re-bucketed through each bucket's geometric midpoint
        (count-exact, value error bounded by this histogram's growth),
        so the quantile-grade SLO sketch folds into the ~20-bucket
        scrape body instead of bloating it."""
        lo, hi, growth = self._geometry
        cur = self._get(labels, lambda: _make_sketch(lo, hi, growth))
        if (sketch.lo, sketch.hi, sketch.growth) == (cur.lo, cur.hi,
                                                     cur.growth):
            self._series[_series_key(labels)] = cur.merge(sketch)
            return
        for i, c in enumerate(sketch.counts):
            if not c:
                continue
            if i == 0:                    # underflow: below sketch.lo
                v = sketch.min if sketch.min is not None else sketch.lo
            elif i == sketch.n_buckets - 1:
                v = sketch.max if sketch.max is not None else sketch.hi
            else:
                edge = sketch.lo * sketch.growth ** (i - 1)
                v = edge * math.sqrt(sketch.growth)
            cur.counts[cur._bucket(v)] += c
        cur.count += sketch.count
        cur.total += sketch.total         # exact, not re-derived
        mins = [m for m in (cur.min, sketch.min) if m is not None]
        maxs = [m for m in (cur.max, sketch.max) if m is not None]
        cur.min = min(mins) if mins else None
        cur.max = max(maxs) if maxs else None

    def render(self) -> List[str]:
        lines = self._header()
        for key, sk in sorted(self._series.items()):
            labels = dict(key)
            cum = 0
            # counts[0] is the underflow bucket (< lo): fold it into the
            # first finite bound; counts[-1] is overflow -> +Inf only.
            for i in range(sk.n_buckets - 1):
                cum += sk.counts[i]
                le = sk.lo * sk.growth ** i
                lines.append(
                    f"{self.name}_bucket"
                    f"{_labelstr(dict(labels, le=_fmt(le)))} {cum}")
            cum += sk.counts[-1]
            lines.append(f"{self.name}_bucket"
                         f"{_labelstr(dict(labels, le='+Inf'))} {cum}")
            lines.append(f"{self.name}_sum{_labelstr(labels)} "
                         f"{_fmt(sk.total)}")
            lines.append(f"{self.name}_count{_labelstr(labels)} "
                         f"{sk.count}")
        return lines


class MetricsRegistry:
    """Order-preserving collection of metrics with one scrape body."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._register(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._register(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "", **kw) -> Histogram:
        return self._register(
            name, lambda: Histogram(name, help_, **kw), Histogram)

    def _register(self, name, mk, cls):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = mk()
        elif not isinstance(m, cls):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind}")
        return m

    def render(self) -> str:
        """Text exposition format 0.0.4 (trailing newline included)."""
        lines: List[str] = []
        for m in self._metrics.values():
            lines.extend(m.render())
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-able {name: {kind, series: {labelstr: value-ish}}}."""
        out: Dict[str, Dict] = {}
        for name, m in self._metrics.items():
            series = {}
            for key, v in m._series.items():
                lbl = _labelstr(dict(key)) or "{}"
                if hasattr(v, "quantile"):      # a histogram's sketch
                    series[lbl] = {"count": v.count, "sum": v.total,
                                   "p50": v.quantile(0.5),
                                   "p99": v.quantile(0.99)}
                else:
                    series[lbl] = v
            out[name] = {"kind": m.kind, "series": series}
        return out


_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?P<labels>\{[^{}]*\})?"
    r"\s+(?P<value>[^\s]+)"
    r"(?:\s+(?P<ts>-?\d+))?$")
_LABELPAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_promtext(text: str) -> Dict[str, Dict]:
    """Strict parser for text exposition format 0.0.4.

    Returns ``{metric_family: {"type": ..., "samples":
    {(sample_name, labelstr): float}}}`` and raises ``ValueError`` on
    any malformed line, unknown TYPE, sample before its TYPE line,
    non-monotonic histogram buckets, or ``le="+Inf"``/``_count``
    mismatch — the checks CI's obs-smoke job relies on."""
    families: Dict[str, Dict] = {}
    typed: Dict[str, str] = {}
    for ln, raw in enumerate(text.split("\n"), 1):
        line = raw.rstrip()
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) < 4:
                raise ValueError(f"line {ln}: malformed TYPE line")
            _, _, name, kind = parts
            if kind not in ("counter", "gauge", "histogram", "summary",
                            "untyped"):
                raise ValueError(f"line {ln}: unknown type {kind!r}")
            if name in typed:
                raise ValueError(f"line {ln}: duplicate TYPE for {name}")
            typed[name] = kind
            families[name] = {"type": kind, "samples": {}}
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample {line!r}")
        sname = m.group("name")
        base = sname
        for suffix in ("_bucket", "_sum", "_count"):
            if sname.endswith(suffix) and sname[:-len(suffix)] in typed:
                base = sname[:-len(suffix)]
                break
        if base not in typed:
            raise ValueError(f"line {ln}: sample {sname!r} before its "
                             "TYPE line")
        val_s = m.group("value")
        if val_s == "+Inf":
            value = math.inf
        elif val_s == "-Inf":
            value = -math.inf
        else:
            try:
                value = float(val_s)
            except ValueError:
                raise ValueError(f"line {ln}: bad value {val_s!r}")
        labels = m.group("labels") or ""
        if labels:
            body = labels[1:-1]
            if body and not re.fullmatch(
                    r'\s*' + _LABELPAIR_RE.pattern +
                    r'(\s*,\s*' + _LABELPAIR_RE.pattern + r')*\s*,?\s*',
                    body):
                raise ValueError(f"line {ln}: malformed labels {labels!r}")
        families[base]["samples"][(sname, labels)] = value
    # histogram invariants: buckets cumulative, +Inf == _count
    for name, fam in families.items():
        if fam["type"] != "histogram":
            continue
        series: Dict[str, List[Tuple[float, float]]] = {}
        counts: Dict[str, float] = {}
        for (sname, labels), value in fam["samples"].items():
            if sname == name + "_bucket":
                pairs = dict(_LABELPAIR_RE.findall(labels))
                le = pairs.get("le")
                if le is None:
                    raise ValueError(f"{name}: bucket sample missing le")
                rest = ",".join(f"{k}={v}" for k, v in sorted(pairs.items())
                                if k != "le")
                bound = math.inf if le == "+Inf" else float(le)
                series.setdefault(rest, []).append((bound, value))
            elif sname == name + "_count":
                pairs = dict(_LABELPAIR_RE.findall(labels))
                rest = ",".join(f"{k}={v}"
                                for k, v in sorted(pairs.items()))
                counts[rest] = value
        for rest, buckets in series.items():
            buckets.sort()
            if not buckets or buckets[-1][0] != math.inf:
                raise ValueError(f"{name}: missing le=\"+Inf\" bucket")
            cum = [c for _, c in buckets]
            if any(b > a for a, b in zip(cum[1:], cum)):
                raise ValueError(f"{name}: non-cumulative buckets")
            if rest in counts and buckets[-1][1] != counts[rest]:
                raise ValueError(
                    f"{name}: le=\"+Inf\" ({buckets[-1][1]}) != _count "
                    f"({counts[rest]})")
    return families
