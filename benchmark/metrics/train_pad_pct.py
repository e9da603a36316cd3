"""Data pipeline (``data/dataset.py``, ``data/collate.py``): padded rows and
frames over the frames the window's steps computed."""


def read(run):
    shapes = run.record.get("shapes")
    if not shapes:
        return None
    total = sum(b * t for b, t in shapes)
    return 100.0 * (total - sum(sum(f for f, _ in rows) for rows in run.record["rows"])) / total
