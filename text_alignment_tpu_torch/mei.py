"""MEI enrichment: merge aligned syllable text into an MEI music-encoding
tree (downstream of the alignment pipeline).

Reference semantics: writeToMEI.py:15-145. For each MEI <syllable> element,
union its neume-component zones, translate that bbox down by the text-line
spacing, pick the max-overlap aligned text box, and either merge the neume
into the previous syllable (same/absent text) or start a new <syl> + <zone>
with a fresh id. The namespace-repair hack for pitchfinding output
(writeToMEI.py:34-38) is kept.

``syls_boxes`` entries are (text, ul, lr) triples — the tuple shape the
reference consumed (writeToMEI.py:98-106, fed from an earlier process()
contract); ``charboxes_to_tuples`` adapts CharBox lists.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np


def intersect(ul1, lr1, ul2, lr2):
    """Overlap area of two rectangles or False (writeToMEI.py:15-21).
    NB the reference mixes axes here (dx from y-coords); preserved."""
    dx = min(lr1[1], lr2[1]) - max(ul1[1], ul2[1])
    dy = min(lr1[0], lr2[0]) - max(ul1[0], ul2[0])
    if (dx > 0) and (dy > 0):
        return dx * dy
    return False


def generate_id(rng=None) -> str:
    """m-xxxxxxxx-xxxx-xxxx-xxxx-xxxxxxxxxxxx id (writeToMEI.py:25-31)."""
    rng = rng or np.random
    s = "m-" + hex(int(rng.randint(0, 16**8)))[2:]
    s += "-" + hex(int(rng.randint(0, 16**4)))[2:]
    s += "-" + hex(int(rng.randint(0, 16**4)))[2:]
    s += "-" + hex(int(rng.randint(0, 16**4)))[2:]
    s += "-" + hex(int(rng.randint(0, 16**12)))[2:]
    return s


def repair_xml(xml_input: str) -> str:
    """Insert the xlink namespace the pitchfinding output forgets
    (writeToMEI.py:34-38)."""
    pt = xml_input.index("meiversion")
    insert = 'xmlns:xlink="http://www.w3.org/1999/xlink" '
    return xml_input[:pt] + insert + xml_input[pt:]


def parse_mei(raw_xml: str) -> ET.ElementTree:
    ET.register_namespace("", "http://www.music-encoding.org/ns/mei")
    try:
        root = ET.fromstring(raw_xml)
    except ET.ParseError:
        root = ET.fromstring(repair_xml(raw_xml))
    tree = ET.ElementTree(root)
    return tree


def charboxes_to_tuples(syl_boxes) -> list:
    return [(b.char, b.ul, b.lr) for b in syl_boxes]


def add_text_to_mei_file(tree: ET.ElementTree, syls_boxes,
                         med_line_spacing: float):
    """Reference: writeToMEI.py:41-145. Returns (tree, all_bboxes,
    assign_lines)."""
    parent_map = {c: p for p in tree.iter() for c in p}

    ns = {
        "id": "{http://www.w3.org/XML/1998/namespace}",
        "mei": "{http://www.music-encoding.org/ns/mei}",
    }

    root = tree.getroot()
    zones = root.findall(".//{}zone".format(ns["mei"]))
    surface = root.findall(".//{}surface".format(ns["mei"]))[0]

    id_to_bbox = {}
    for zone in zones:
        zid = zone.attrib[ns["id"] + "id"]
        id_to_bbox[zid] = zone.attrib

    syllable_elements = root.findall(".//{}syllable".format(ns["mei"]))
    all_bboxes = []

    cur_syllable = None
    prev_text = None
    prev_assigned_text = None
    elements_to_remove = []
    assign_lines = []

    for se in syllable_elements:
        neume = se[0]

        if cur_syllable is None:
            cur_syllable = se

        assert "neume" in neume.tag

        neume_components = neume.findall(ns["mei"] + "nc")
        bboxes = [id_to_bbox[nc.attrib["facs"]] for nc in neume_components]

        lrx = max(int(bb["lrx"]) for bb in bboxes)
        lry = max(int(bb["lry"]) for bb in bboxes)
        ulx = min(int(bb["ulx"]) for bb in bboxes)
        uly = min(int(bb["uly"]) for bb in bboxes)
        all_bboxes.append([ulx, uly, lrx, lry])

        # translate downward by the line spacing to land on the text below
        trans_lry = lry + med_line_spacing
        trans_uly = uly + med_line_spacing / 2

        colliding_syls = [
            s
            for s in syls_boxes
            if intersect(s[1], s[2], (ulx, trans_uly), (lrx, trans_lry)) > 0
        ]

        if colliding_syls:
            leftmost_colliding_text = max(
                colliding_syls,
                key=lambda s: intersect(
                    s[1], s[2], (ulx, trans_uly), (lrx, trans_lry)
                ),
            )
            prev_assigned_text = leftmost_colliding_text
        else:
            leftmost_colliding_text = None

        if (not leftmost_colliding_text) or (leftmost_colliding_text == prev_text):
            cur_syllable.append(neume)
            elements_to_remove.append(se)
        else:
            cur_syllable = se
            new_syl_el = ET.Element("syl")
            new_syl_el.text = leftmost_colliding_text[0]
            cur_syllable.insert(0, new_syl_el)

            new_zone = ET.SubElement(surface, "{}zone".format(ns["mei"]))
            new_id = generate_id()
            cur_syllable.set("facs", new_id)

            new_zone.set(ns["id"] + "id", new_id)
            new_zone.set("lrx", str(lrx))
            new_zone.set("lry", str(lry))
            new_zone.set("ulx", str(ulx))
            new_zone.set("uly", str(uly))

        if prev_assigned_text:
            assign_lines.append(
                [ulx, uly, prev_assigned_text[1][0], prev_assigned_text[1][1]]
            )

        prev_text = leftmost_colliding_text

    for el in elements_to_remove:
        parent_map[el].remove(el)

    return tree, all_bboxes, assign_lines
