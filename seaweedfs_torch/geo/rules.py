"""S3 bucket replication configuration — the supported XML subset.

The port's copy of seaweedfs_tpu/geo/rules.py, whole. The port's S3
gateway stores, reads and deletes these rules; the replicator that acts
on them (the master's geo daemon) waits for ROADMAP A.8.

PutBucketReplication / GetBucketReplication store a parsed-rule JSON
document in the bucket directory entry's extended attributes (exactly
where lifecycle rules live, lifecycle/s3_rules.py), and the master's
geo daemon enforces it: one BucketReplicator job per bucket with an
enabled rule.

Supported subset (everything else rejected as MalformedXML rather than
silently dropped — a rule the daemon won't enforce must not look
accepted):

  <ReplicationConfiguration>
    <Role>optional, ignored</Role>
    <Rule>
      <ID>optional</ID>
      <Status>Enabled|Disabled</Status>
      <Prefix>logs/</Prefix>          (or <Filter><Prefix>)
      <Destination>
        <Bucket>arn:aws:s3:::dest-bucket</Bucket>
        <Endpoint>host:port</Endpoint>   (extension: the remote
                                          cluster's filer; falls back
                                          to WEED_GEO_PEER)
      </Destination>
    </Rule>
  </ReplicationConfiguration>

AWS ARNs carry no endpoint, so ``<Endpoint>`` is this project's
extension naming the remote cluster's filer address; a deployment with
one fixed peer cluster can omit it and configure ``WEED_GEO_PEER`` on
the master instead.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"

# the extended-attribute key on the bucket directory entry
BUCKET_ATTR = "seaweed-replication"

MAX_RULES = 16

_ARN_PREFIX = "arn:aws:s3:::"


class ReplicationXmlError(ValueError):
    pass


def _strip(tag: str) -> str:
    return tag.split("}", 1)[1] if tag.startswith("{") else tag


def _find(el, name):
    for child in el:
        if _strip(child.tag) == name:
            return child
    return None


def parse_replication_xml(body: bytes) -> list[dict]:
    """XML -> [{id, status, prefix, dest_bucket, endpoint}] — raises
    ReplicationXmlError on anything outside the supported subset."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise ReplicationXmlError(str(e))
    if _strip(root.tag) != "ReplicationConfiguration":
        raise ReplicationXmlError(
            f"expected ReplicationConfiguration, got {_strip(root.tag)}")
    rules: list[dict] = []
    for rule_el in root:
        name = _strip(rule_el.tag)
        if name == "Role":
            continue  # IAM role: meaningless here, tolerated for SDKs
        if name != "Rule":
            raise ReplicationXmlError(f"unexpected element {name}")
        rule = {"id": "", "status": "Enabled", "prefix": "",
                "dest_bucket": "", "endpoint": ""}
        for el in rule_el:
            ename = _strip(el.tag)
            if ename == "ID":
                rule["id"] = el.text or ""
            elif ename == "Status":
                if el.text not in ("Enabled", "Disabled"):
                    raise ReplicationXmlError(f"bad Status {el.text!r}")
                rule["status"] = el.text
            elif ename == "Prefix":
                rule["prefix"] = el.text or ""
            elif ename == "Filter":
                pfx = _find(el, "Prefix")
                rule["prefix"] = (pfx.text or "") if pfx is not None else ""
            elif ename == "Priority":
                continue  # tolerated; first enabled rule wins here
            elif ename == "Destination":
                bucket_el = _find(el, "Bucket")
                if bucket_el is None or not (bucket_el.text or ""):
                    raise ReplicationXmlError(
                        "Destination needs a Bucket")
                b = bucket_el.text
                rule["dest_bucket"] = (b[len(_ARN_PREFIX):]
                                       if b.startswith(_ARN_PREFIX) else b)
                ep = _find(el, "Endpoint")
                rule["endpoint"] = (ep.text or "") if ep is not None else ""
            else:
                raise ReplicationXmlError(f"unsupported element {ename}")
        if not rule["dest_bucket"]:
            raise ReplicationXmlError("rule needs a Destination/Bucket")
        rules.append(rule)
    if not rules:
        raise ReplicationXmlError("no rules")
    if len(rules) > MAX_RULES:
        raise ReplicationXmlError(f"more than {MAX_RULES} rules")
    return rules


def rules_to_xml(rules: list[dict]) -> bytes:
    root = ET.Element("ReplicationConfiguration", xmlns=XMLNS)
    for rule in rules:
        r = ET.SubElement(root, "Rule")
        if rule.get("id"):
            ET.SubElement(r, "ID").text = rule["id"]
        ET.SubElement(r, "Status").text = rule.get("status", "Enabled")
        ET.SubElement(r, "Prefix").text = rule.get("prefix", "")
        d = ET.SubElement(r, "Destination")
        ET.SubElement(d, "Bucket").text = \
            _ARN_PREFIX + rule.get("dest_bucket", "")
        if rule.get("endpoint"):
            ET.SubElement(d, "Endpoint").text = rule["endpoint"]
    return (b'<?xml version="1.0" encoding="UTF-8"?>\n'
            + ET.tostring(root))


def rules_to_json(rules: list[dict]) -> str:
    return json.dumps(rules, sort_keys=True)


def rules_from_json(raw: str) -> list[dict]:
    try:
        rules = json.loads(raw)
    except (TypeError, ValueError):
        return []
    return rules if isinstance(rules, list) else []


def active_rule(rules: list[dict]) -> dict | None:
    """The rule the daemon enforces: first enabled one (one replication
    job per bucket — matching priorities is AWS surface we don't carry)."""
    for rule in rules:
        if rule.get("status") == "Enabled" and rule.get("dest_bucket"):
            return rule
    return None
