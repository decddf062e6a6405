"""S3 bucket lifecycle configuration — the supported XML subset.

The port's copy of seaweedfs_tpu/lifecycle/s3_rules.py, whole. The
port has no S3 gateway yet: its rules reach the bucket entry through the
filer's /__meta__/update_entry.

PutBucketLifecycleConfiguration / GetBucketLifecycleConfiguration store a
parsed-rule JSON document in the bucket directory entry's extended
attributes (the same place object tags live), and the master's lifecycle
daemon enforces it through the filer's /__meta__ API.

Supported subset (everything else is rejected as MalformedXML rather
than silently dropped — a rule the daemon won't enforce must not look
accepted):

  <LifecycleConfiguration>
    <Rule>
      <ID>optional</ID>
      <Filter><Prefix>logs/</Prefix></Filter>   (or bare <Prefix>)
      <Status>Enabled|Disabled</Status>
      <Expiration><Days>N</Days></Expiration>
      <Transition>
        <Days>N</Days><StorageClass>WARM</StorageClass>
      </Transition>
    </Rule>
  </LifecycleConfiguration>

Transition's only storage class is WARM — this cluster's warm tier is
the RS(10,4) EC layer, so a Transition rule marks aged objects
x-amz-storage-class: WARM and nudges the volumes holding their chunks
into the hot->warm EC transition.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"

# the extended-attribute key on the bucket directory entry
BUCKET_ATTR = "seaweed-lifecycle"
# the extended-attribute key on object entries
STORAGE_CLASS_ATTR = "x-amz-storage-class"
WARM_CLASS = "WARM"

MAX_RULES = 100


class LifecycleXmlError(ValueError):
    pass


def _strip(tag: str) -> str:
    return tag.split("}", 1)[1] if tag.startswith("{") else tag


def _find(el, name):
    for child in el:
        if _strip(child.tag) == name:
            return child
    return None


def parse_lifecycle_xml(body: bytes) -> list[dict]:
    """XML -> [{id, status, prefix, expire_days, transition_days,
    transition_class}] — raises LifecycleXmlError on anything outside
    the supported subset."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError as e:
        raise LifecycleXmlError(str(e))
    if _strip(root.tag) != "LifecycleConfiguration":
        raise LifecycleXmlError(
            f"expected LifecycleConfiguration, got {_strip(root.tag)}")
    rules: list[dict] = []
    for rule_el in root:
        if _strip(rule_el.tag) != "Rule":
            raise LifecycleXmlError(
                f"unexpected element {_strip(rule_el.tag)}")
        rule = {"id": "", "status": "Enabled", "prefix": "",
                "expire_days": None, "transition_days": None,
                "transition_class": ""}
        for el in rule_el:
            name = _strip(el.tag)
            if name == "ID":
                rule["id"] = el.text or ""
            elif name == "Status":
                if el.text not in ("Enabled", "Disabled"):
                    raise LifecycleXmlError(f"bad Status {el.text!r}")
                rule["status"] = el.text
            elif name == "Prefix":
                rule["prefix"] = el.text or ""
            elif name == "Filter":
                pfx = _find(el, "Prefix")
                rule["prefix"] = (pfx.text or "") if pfx is not None else ""
            elif name == "Expiration":
                days = _find(el, "Days")
                if days is None:
                    raise LifecycleXmlError(
                        "only Expiration/Days is supported")
                rule["expire_days"] = _days(days.text)
            elif name == "Transition":
                days = _find(el, "Days")
                cls = _find(el, "StorageClass")
                if days is None or cls is None:
                    raise LifecycleXmlError(
                        "Transition needs Days and StorageClass")
                if (cls.text or "").upper() != WARM_CLASS:
                    raise LifecycleXmlError(
                        f"unsupported StorageClass {cls.text!r} "
                        f"(only {WARM_CLASS})")
                rule["transition_days"] = _days(days.text)
                rule["transition_class"] = WARM_CLASS
            else:
                raise LifecycleXmlError(f"unsupported element {name}")
        if rule["expire_days"] is None and rule["transition_days"] is None:
            raise LifecycleXmlError(
                "rule needs an Expiration or a Transition")
        rules.append(rule)
    if not rules:
        raise LifecycleXmlError("no rules")
    if len(rules) > MAX_RULES:
        raise LifecycleXmlError(f"more than {MAX_RULES} rules")
    return rules


def _days(text) -> float:
    try:
        days = float(text)
    except (TypeError, ValueError):
        raise LifecycleXmlError(f"bad Days {text!r}")
    if days < 0:
        raise LifecycleXmlError("Days must be >= 0")
    return days


def rules_to_xml(rules: list[dict]) -> bytes:
    root = ET.Element("LifecycleConfiguration", xmlns=XMLNS)
    for rule in rules:
        r = ET.SubElement(root, "Rule")
        if rule.get("id"):
            ET.SubElement(r, "ID").text = rule["id"]
        f = ET.SubElement(r, "Filter")
        ET.SubElement(f, "Prefix").text = rule.get("prefix", "")
        ET.SubElement(r, "Status").text = rule.get("status", "Enabled")
        if rule.get("expire_days") is not None:
            e = ET.SubElement(r, "Expiration")
            ET.SubElement(e, "Days").text = _fmt_days(rule["expire_days"])
        if rule.get("transition_days") is not None:
            t = ET.SubElement(r, "Transition")
            ET.SubElement(t, "Days").text = _fmt_days(
                rule["transition_days"])
            ET.SubElement(t, "StorageClass").text = WARM_CLASS
    return (b'<?xml version="1.0" encoding="UTF-8"?>\n'
            + ET.tostring(root))


def _fmt_days(days: float) -> str:
    return str(int(days)) if float(days).is_integer() else str(days)


def rules_to_json(rules: list[dict]) -> str:
    return json.dumps(rules, sort_keys=True)


def rules_from_json(raw: str) -> list[dict]:
    try:
        rules = json.loads(raw)
    except (TypeError, ValueError):
        return []
    return rules if isinstance(rules, list) else []
