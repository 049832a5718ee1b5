"""ElasticSearch I/O for XShards (counterpart of
``zoo_tpu/orca/data/elastic_search.py``; the reference's
``elastic_search.read_df`` / ``write_df`` / ``read_rdd`` over the
es-hadoop Spark connector).

It talks to ES over its REST API through the official ``elasticsearch``
client (8.x calling conventions) where that package is installed, and
raises the JAX package's message where it is not. Results land in pandas
DataFrames and :class:`~zoo_tpu_torch.orca.data.shard.LocalXShards`.
Reads paginate with ``search_after`` so a whole index comes back; writes
use the bulk API. pandas and ``elasticsearch`` are imported when a
function runs, never when this module is imported.
"""

from __future__ import annotations

import importlib
from typing import Optional

_PAGE = 1000


def _pandas():
    module = "pandas"
    return importlib.import_module(module)


def _split_host_port(h: str, default: int):
    """host / host:port / [v6]:port / bare v6: only a suffix that is a
    numeric port is stripped."""
    if h.startswith("["):  # [v6addr]:port or [v6addr]
        addr, _, rest = h[1:].partition("]")
        port = rest[1:] if rest.startswith(":") else ""
        return addr, int(port) if port.isdigit() else default
    head, _, tail = h.rpartition(":")
    if head and tail.isdigit() and ":" not in head:
        return head, int(tail)
    return h, default  # a bare host or a bare IPv6 literal


def _client(es_config: dict):
    module = "elasticsearch"
    try:
        Elasticsearch = importlib.import_module(module).Elasticsearch
    except ImportError as e:
        raise ImportError(
            "elastic_search I/O needs the `elasticsearch` package "
            "(pip install elasticsearch); it is not bundled with zoo_tpu"
        ) from e
    default_port = int(es_config.get("es.port", 9200))
    hosts = es_config.get("es.nodes", "localhost")
    if isinstance(hosts, str):
        hosts = [h.strip() for h in hosts.split(",")]
    nodes = []
    for h in hosts:  # es-hadoop allows bare hosts or host:port entries
        scheme = "http"
        if "://" in h:
            scheme, h = h.split("://", 1)
        host, port = _split_host_port(h, default_port)
        nodes.append({"host": host, "port": port, "scheme": scheme})
    kwargs = {}
    user = es_config.get("es.net.http.auth.user")
    if user:
        kwargs["basic_auth"] = (user,
                                es_config.get("es.net.http.auth.pass", ""))
    return Elasticsearch(nodes, **kwargs)


class elastic_search:  # noqa: N801 (the reference spells the class so)
    """Primitives for ES interaction (the reference's class)."""

    @staticmethod
    def read_df(es_config: dict, es_resource: str,
                schema: Optional[list] = None,
                query: Optional[dict] = None,
                size: Optional[int] = None):
        """An index as a pandas DataFrame (``schema`` selects columns),
        paginated with ``search_after`` so indices larger than the ES
        result window come back whole; ``size`` caps the rows."""
        es = _client(es_config)
        pd = _pandas()
        rows, after = [], None
        q = query or {"match_all": {}}
        while True:
            page = (min(_PAGE, size - len(rows)) if size is not None
                    else _PAGE)
            if page <= 0:
                break
            resp = es.search(index=es_resource, query=q, size=page,
                             sort=[{"_doc": "asc"}],
                             search_after=after)
            hits = resp["hits"]["hits"]
            if not hits:
                break
            rows.extend(h["_source"] for h in hits)
            after = hits[-1]["sort"]
        df = pd.json_normalize(rows)  # the reference's flatten: dotted
        if schema:
            df = df[[c for c in schema if c in df.columns]]
        return df

    @staticmethod
    def write_df(es_config: dict, es_resource: str, df,
                 chunk_size: int = 1000):
        """A DataFrame into an index through the bulk API."""
        es = _client(es_config)
        records = df.to_dict(orient="records")
        for start in range(0, len(records), chunk_size):
            ops = []
            for doc in records[start:start + chunk_size]:
                ops.append({"index": {"_index": es_resource}})
                ops.append(doc)
            if ops:
                resp = es.bulk(operations=ops)
                if resp.get("errors"):
                    bad = [i["index"] for i in resp["items"]
                           if i.get("index", {}).get("error")][:3]
                    raise RuntimeError(f"bulk index failures: {bad}")
        es.indices.refresh(index=es_resource)

    @staticmethod
    def read_shards(es_config: dict, es_resource: str,
                    query: Optional[dict] = None,
                    num_shards: Optional[int] = None):
        """An index as XShards of DataFrames (the reference's ``read_rdd``
        landed in an RDD)."""
        from zoo_tpu_torch.orca.data.shard import LocalXShards
        df = elastic_search.read_df(es_config, es_resource, query=query)
        return LocalXShards.partition(df, num_shards or 4)

    read_rdd = read_shards
