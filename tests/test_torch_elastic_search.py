"""The port's ElasticSearch reader and writer against the JAX package's,
both over one stub ``elasticsearch`` module placed in ``sys.modules`` (no
server, no socket): the client's construction, every ``search`` (the
``search_after`` pages), ``bulk`` and ``refresh`` call, the frames read
and the XShards; and the message where the package is missing. Exact:
calls, frames and messages compare equal.
"""

import sys
import types

import pandas as pd
import pytest

from zoo_tpu.orca.data.elastic_search import elastic_search as JES

from zoo_tpu_torch.orca.data.elastic_search import elastic_search as TES


def _stub(calls, docs):
    """An ``elasticsearch`` module whose client serves ``docs`` (an
    index of dicts) page by page and records every call."""

    class Indices:
        def refresh(self, index):
            calls.append(("refresh", index))

    class Elasticsearch:
        def __init__(self, nodes, **kwargs):
            calls.append(("client", nodes, kwargs))
            self.indices = Indices()

        def search(self, index, query, size, sort, search_after):
            calls.append(("search", index, query, size, sort, search_after))
            start = 0 if search_after is None else search_after[0] + 1
            hits = [{"_source": d, "sort": [i]} for i, d in
                    enumerate(docs[start:start + size], start)]
            return {"hits": {"hits": hits}}

        def bulk(self, operations):
            calls.append(("bulk", operations))
            return {"errors": False, "items": []}

    mod = types.ModuleType("elasticsearch")
    mod.Elasticsearch = Elasticsearch
    return mod


def _docs(n):
    return [{"id": i, "user": {"name": f"u{i}", "age": 20 + i % 7}}
            for i in range(n)]


def _run(es, monkeypatch, docs, **kw):
    calls = []
    monkeypatch.setitem(sys.modules, "elasticsearch", _stub(calls, docs))
    cfg = {"es.nodes": "h1:9201, [::1]:9300, https://h3", "es.port": 9200,
           "es.net.http.auth.user": "u", "es.net.http.auth.pass": "p"}
    df = es.read_df(cfg, "idx", **kw)
    shards = es.read_shards(cfg, "idx", num_shards=3)
    es.write_df(cfg, "out", df.head(5), chunk_size=2)
    return calls, df, shards


@pytest.mark.parametrize("n,kw", [(2500, {}), (2500, {"size": 1200}),
                                  (7, {"schema": ["user.name", "id", "x"]}),
                                  (0, {})])
def test_read_and_write_make_jaxs_calls(monkeypatch, n, kw):
    mine = _run(TES, monkeypatch, _docs(n), **kw)
    theirs = _run(JES, monkeypatch, _docs(n), **kw)
    assert mine[0] == theirs[0]
    pd.testing.assert_frame_equal(mine[1], theirs[1])
    a, b = mine[2].collect(), theirs[2].collect()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        pd.testing.assert_frame_equal(x.reset_index(drop=True),
                                      y.reset_index(drop=True))
    pages = [c for c in mine[0] if c[0] == "search"]
    want = min(n, kw.get("size", n))
    assert len(mine[1]) == want
    assert sum(1 for c in mine[0] if c[0] == "bulk") == \
        (0 if n == 0 else 3 if want >= 5 else (want + 1) // 2)
    assert pages[0][5] is None   # the first page has no search_after


def test_read_rdd_is_read_shards(monkeypatch):
    calls = []
    monkeypatch.setitem(sys.modules, "elasticsearch", _stub(calls, _docs(9)))
    got = TES.read_rdd({"es.nodes": "h"}, "idx", num_shards=2).collect()
    assert [len(s) for s in got] == [4, 5]


def test_bulk_failures_raise(monkeypatch):
    calls = []
    mod = _stub(calls, [])
    mod.Elasticsearch.bulk = lambda self, operations: {
        "errors": True, "items": [{"index": {"error": "boom"}}]}
    monkeypatch.setitem(sys.modules, "elasticsearch", mod)
    for es in (TES, JES):
        with pytest.raises(RuntimeError, match="bulk index failures"):
            es.write_df({}, "out", pd.DataFrame({"a": [1]}))


def test_missing_package_raises_jaxs_message(monkeypatch):
    monkeypatch.setitem(sys.modules, "elasticsearch", None)
    msgs = []
    for es in (TES, JES):
        with pytest.raises(ImportError) as e:
            es.read_df({}, "idx")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "elasticsearch" in msgs[0]


def test_importing_the_module_pulls_in_no_pandas():
    import subprocess
    code = ("import sys; import zoo_tpu_torch.orca.data.elastic_search; "
            "bad = [m for m in ('pandas', 'elasticsearch') if m in "
            "sys.modules]; assert not bad, bad")
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       env=dict(os.environ, PYTHONPATH=root),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
