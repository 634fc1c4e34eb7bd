"""Chart, table and text components as JSON and standalone HTML: the
port's own copy of ``deeplearning4j_tpu/ui/components.py``
(``deeplearning4j-ui-components``: the component beans of
``ui/components/chart/*.java``, ``table`` and ``text``, and
``standalone/StaticPageUtil.java``). Rendering is inline SVG, so a report
is one self-contained file; the same components render the same bytes
as the reference's.
"""

from __future__ import annotations

import json

__all__ = ["ChartHistogram", "ChartLine", "Component", "ComponentTable",
           "ComponentText", "render_standalone_html"]

_PALETTE = ["#2563eb", "#dc2626", "#059669", "#d97706", "#7c3aed", "#0891b2"]


class Component:
    """Base bean: every component serializes to a typed JSON dict."""

    component_type = "Component"

    def to_dict(self):
        raise NotImplementedError

    def to_json(self):
        return json.dumps(self.to_dict())

    def render_svg(self, width=560, height=300):
        raise NotImplementedError


class ComponentText(Component):
    component_type = "ComponentText"

    def __init__(self, text, size=13):
        self.text = text
        self.size = size

    def to_dict(self):
        return {"type": self.component_type, "text": self.text, "size": self.size}

    def render_svg(self, width=560, height=None):
        return (f'<div style="font-size:{self.size}px;margin:6px 0">'
                f"{self.text}</div>")


class ComponentTable(Component):
    component_type = "ComponentTable"

    def __init__(self, header, rows, title=None):
        self.header = list(header)
        self.rows = [list(r) for r in rows]
        self.title = title

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "header": self.header, "rows": self.rows}

    def render_svg(self, width=560, height=None):
        out = ['<table style="border-collapse:collapse;font-size:12px;margin:6px 0">']
        if self.title:
            out.append(f'<caption style="text-align:left;font-weight:600">{self.title}</caption>')
        out.append("<tr>" + "".join(
            f'<th style="border:1px solid #ccc;padding:3px 8px;background:#f0f2f7">{h}</th>'
            for h in self.header) + "</tr>")
        for r in self.rows:
            out.append("<tr>" + "".join(
                f'<td style="border:1px solid #ccc;padding:3px 8px">{c}</td>'
                for c in r) + "</tr>")
        out.append("</table>")
        return "".join(out)


class ChartLine(Component):
    """Multi-series line chart (ui/components/chart/ChartLine.java)."""

    component_type = "ChartLine"

    def __init__(self, title, x_label="", y_label=""):
        self.title = title
        self.x_label = x_label
        self.y_label = y_label
        self.series = []  # (name, xs, ys)

    def add_series(self, name, x, y):
        self.series.append((name, [float(v) for v in x], [float(v) for v in y]))
        return self

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "xLabel": self.x_label, "yLabel": self.y_label,
                "series": [{"name": n, "x": x, "y": y} for n, x, y in self.series]}

    def render_svg(self, width=560, height=300):
        pad = 44
        xs = [v for _, x, _ in self.series for v in x]
        ys = [v for _, _, y in self.series for v in y]
        if not xs:
            return f"<svg width='{width}' height='{height}'></svg>"
        x0, x1, y0, y1 = min(xs), max(xs), min(ys), max(ys)

        def sx(v):
            return pad + (width - 2 * pad) * ((v - x0) / (x1 - x0) if x1 > x0 else 0.5)

        def sy(v):
            return height - pad - (height - 2 * pad) * ((v - y0) / (y1 - y0) if y1 > y0 else 0.5)

        parts = [f"<svg width='{width}' height='{height}' xmlns='http://www.w3.org/2000/svg'>",
                 f"<text x='{width/2}' y='16' text-anchor='middle' font-size='13' font-weight='600'>{self.title}</text>",
                 f"<line x1='{pad}' y1='{height-pad}' x2='{width-pad}' y2='{height-pad}' stroke='#999'/>",
                 f"<line x1='{pad}' y1='{pad}' x2='{pad}' y2='{height-pad}' stroke='#999'/>",
                 f"<text x='{pad}' y='{height-8}' font-size='10'>{x0:.3g}</text>",
                 f"<text x='{width-pad}' y='{height-8}' font-size='10' text-anchor='end'>{x1:.3g}</text>",
                 f"<text x='4' y='{height-pad}' font-size='10'>{y0:.3g}</text>",
                 f"<text x='4' y='{pad}' font-size='10'>{y1:.3g}</text>"]
        for i, (name, x, y) in enumerate(self.series):
            color = _PALETTE[i % len(_PALETTE)]
            d = " ".join(f"{'M' if j == 0 else 'L'}{sx(a):.1f} {sy(b):.1f}"
                         for j, (a, b) in enumerate(zip(x, y)))
            parts.append(f"<path d='{d}' fill='none' stroke='{color}' stroke-width='1.5'/>")
            parts.append(f"<text x='{pad+6+i*120}' y='{pad-6}' font-size='10' fill='{color}'>{name}</text>")
        parts.append("</svg>")
        return "".join(parts)


class ChartHistogram(Component):
    """Histogram bars (ui/components/chart/ChartHistogram.java)."""

    component_type = "ChartHistogram"

    def __init__(self, title, lower, upper, counts):
        self.title = title
        self.lower = [float(v) for v in lower]
        self.upper = [float(v) for v in upper]
        self.counts = [float(v) for v in counts]

    def to_dict(self):
        return {"type": self.component_type, "title": self.title,
                "lower": self.lower, "upper": self.upper, "counts": self.counts}

    def render_svg(self, width=560, height=300):
        pad = 40
        if not self.counts:
            return f"<svg width='{width}' height='{height}'></svg>"
        cmax = max(self.counts) or 1.0
        n = len(self.counts)
        parts = [f"<svg width='{width}' height='{height}' xmlns='http://www.w3.org/2000/svg'>",
                 f"<text x='{width/2}' y='16' text-anchor='middle' font-size='13' font-weight='600'>{self.title}</text>"]
        for i, c in enumerate(self.counts):
            h = (height - 2 * pad) * c / cmax
            x = pad + (width - 2 * pad) * i / n
            parts.append(f"<rect x='{x:.1f}' y='{height-pad-h:.1f}' "
                         f"width='{(width-2*pad)/n-1:.1f}' height='{h:.1f}' fill='#2563eb'/>")
        parts.append(f"<text x='{pad}' y='{height-8}' font-size='10'>{self.lower[0]:.3g}</text>")
        parts.append(f"<text x='{width-pad}' y='{height-8}' font-size='10' text-anchor='end'>{self.upper[-1]:.3g}</text>")
        parts.append("</svg>")
        return "".join(parts)


def render_standalone_html(components, title="Report"):
    """Self-contained HTML page from a component list (StaticPageUtil role)."""
    body = "\n".join(c.render_svg() for c in components)
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{title}</title>"
            f"<style>body{{font-family:system-ui,sans-serif;margin:24px}}"
            f"svg{{display:block;margin:12px 0;background:#fff}}</style></head>"
            f"<body><h1 style='font-size:18px'>{title}</h1>{body}</body></html>")
