"""Offline toponym gazetteer: place name -> coordinates
(port of ``shodh_tpu/nlp/gazetteer.py``).

Reference: ``src/gazetteer/mod.rs`` — GeoNames-derived toponym resolution
with population-weighted homonym disambiguation (mod.rs:25-27: "London is
the one in England"), filling ``Experience.toponyms`` (deliberately NOT the
geo index — mod.rs:10-15: a note *mentioning* Baltimore must never surface
for "within 5km of Baltimore").

Data: ships the full GeoNames ``cities15000`` subset (~34k places over
15,000 inhabitants — the same public CC BY 4.0 dataset the reference embeds,
mod.rs:34-40) as ``nlp/data/geonames_cities.tsv.gz``, built by
``tools/build_gazetteer.py``; loaded lazily on first use. A small built-in
seed list keeps the subsystem working even without the artifact, and
``load_tsv`` accepts user-provided GeoNames TSVs.

Resolution is case-insensitive exact match with population-weighted argmax
(mod.rs:18-31: no fuzzy matching — a wrong-but-plausible link is worse than
no link). Free-text extraction, which the reference does not attempt (its
gazetteer only resolves NER LOC entities, mod.rs:166-177), additionally
guards against city names that are common English words ("split", "nice",
"mobile", "of" — all real cities15000 rows): non-builtin single-token names
need capitalization evidence at a non-sentence-initial position, or a
metropolis-scale population.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

from shodh_tpu_torch.nlp.stopwords import STOPWORDS

# (name, lat, lon, population) rows. Built-in seed (public-knowledge data,
# coords city-center approximate): major world cities, countries (anchored
# at the capital; population = country), US states (anchored at the
# capital), and deliberate homonym rows (Cambridge/Portland/San Jose/...)
# so population-weighted disambiguation has real work offline.
_BUILTIN_ROWS: list[tuple[str, float, float, int]] = [
    # -- world cities ---------------------------------------------------------
    ("new york", 40.71, -74.01, 8_400_000),
    ("london", 51.51, -0.13, 8_900_000),
    ("paris", 48.86, 2.35, 2_100_000),
    ("berlin", 52.52, 13.41, 3_700_000),
    ("tokyo", 35.68, 139.65, 13_900_000),
    ("san francisco", 37.77, -122.42, 880_000),
    ("seattle", 47.61, -122.33, 740_000),
    ("austin", 30.27, -97.74, 960_000),
    ("boston", 42.36, -71.06, 690_000),
    ("chicago", 41.88, -87.63, 2_700_000),
    ("los angeles", 34.05, -118.24, 3_900_000),
    ("toronto", 43.65, -79.38, 2_900_000),
    ("sydney", -33.87, 151.21, 5_300_000),
    ("singapore", 1.35, 103.82, 5_600_000),
    ("bangalore", 12.97, 77.59, 8_400_000),
    ("mumbai", 19.08, 72.88, 12_400_000),
    ("delhi", 28.70, 77.10, 11_000_000),
    ("beijing", 39.90, 116.41, 21_500_000),
    ("shanghai", 31.23, 121.47, 24_200_000),
    ("dubai", 25.20, 55.27, 3_300_000),
    ("amsterdam", 52.37, 4.90, 870_000),
    ("zurich", 47.38, 8.54, 430_000),
    ("dublin", 53.35, -6.26, 550_000),
    ("madrid", 40.42, -3.70, 3_200_000),
    ("rome", 41.90, 12.50, 2_800_000),
    ("moscow", 55.76, 37.62, 12_500_000),
    ("seoul", 37.57, 126.98, 9_700_000),
    ("sao paulo", -23.55, -46.63, 12_300_000),
    ("mexico city", 19.43, -99.13, 9_200_000),
    ("cairo", 30.04, 31.24, 9_500_000),
    ("lagos", 6.52, 3.38, 14_800_000),
    ("nairobi", -1.29, 36.82, 4_400_000),
    ("hong kong", 22.32, 114.17, 7_400_000),
    ("taipei", 25.03, 121.57, 2_600_000),
    ("osaka", 34.69, 135.50, 2_700_000),
    ("kyoto", 35.01, 135.77, 1_460_000),
    ("shenzhen", 22.54, 114.06, 12_600_000),
    ("guangzhou", 23.13, 113.26, 13_100_000),
    ("bangkok", 13.76, 100.50, 8_300_000),
    ("jakarta", -6.21, 106.85, 10_600_000),
    ("manila", 14.60, 120.98, 1_800_000),
    ("ho chi minh city", 10.82, 106.63, 8_400_000),
    ("hanoi", 21.03, 105.85, 7_800_000),
    ("kuala lumpur", 3.14, 101.69, 1_800_000),
    ("karachi", 24.86, 67.01, 14_900_000),
    ("lahore", 31.55, 74.34, 11_100_000),
    ("dhaka", 23.81, 90.41, 8_900_000),
    ("chennai", 13.08, 80.27, 7_100_000),
    ("hyderabad", 17.39, 78.49, 6_800_000),
    ("pune", 18.52, 73.86, 3_100_000),
    ("kolkata", 22.57, 88.36, 4_500_000),
    ("tel aviv", 32.09, 34.78, 460_000),
    ("jerusalem", 31.77, 35.21, 940_000),
    ("istanbul", 41.01, 28.98, 15_500_000),
    ("ankara", 39.93, 32.86, 5_600_000),
    ("riyadh", 24.71, 46.68, 7_000_000),
    ("doha", 25.29, 51.53, 640_000),
    ("abu dhabi", 24.45, 54.38, 1_500_000),
    ("tehran", 35.69, 51.39, 8_700_000),
    ("baghdad", 33.31, 44.37, 7_100_000),
    ("johannesburg", -26.20, 28.05, 5_600_000),
    ("cape town", -33.92, 18.42, 4_600_000),
    ("accra", 5.60, -0.19, 2_300_000),
    ("addis ababa", 9.01, 38.75, 3_400_000),
    ("casablanca", 33.57, -7.59, 3_400_000),
    ("tunis", 36.81, 10.18, 640_000),
    ("algiers", 36.75, 3.06, 2_400_000),
    ("kinshasa", -4.44, 15.27, 14_300_000),
    ("buenos aires", -34.60, -58.38, 3_100_000),
    ("santiago", -33.45, -70.67, 6_200_000),
    ("lima", -12.05, -77.04, 9_700_000),
    ("bogota", 4.71, -74.07, 7_400_000),
    ("caracas", 10.48, -66.90, 2_900_000),
    ("rio de janeiro", -22.91, -43.17, 6_700_000),
    ("brasilia", -15.79, -47.88, 3_000_000),
    ("montevideo", -34.90, -56.16, 1_300_000),
    ("quito", -0.18, -78.47, 1_800_000),
    ("havana", 23.11, -82.37, 2_100_000),
    ("vancouver", 49.28, -123.12, 680_000),
    ("montreal", 45.50, -73.57, 1_800_000),
    ("ottawa", 45.42, -75.70, 1_000_000),
    ("calgary", 51.05, -114.07, 1_300_000),
    ("melbourne", -37.81, 144.96, 5_100_000),
    ("brisbane", -27.47, 153.03, 2_500_000),
    ("perth", -31.95, 115.86, 2_100_000),
    ("auckland", -36.85, 174.76, 1_700_000),
    ("wellington", -41.29, 174.78, 420_000),
    ("stockholm", 59.33, 18.07, 980_000),
    ("oslo", 59.91, 10.75, 700_000),
    ("copenhagen", 55.68, 12.57, 640_000),
    ("helsinki", 60.17, 24.94, 660_000),
    ("reykjavik", 64.15, -21.94, 130_000),
    ("vienna", 48.21, 16.37, 1_900_000),
    ("prague", 50.08, 14.44, 1_300_000),
    ("budapest", 47.50, 19.04, 1_750_000),
    ("warsaw", 52.23, 21.01, 1_800_000),
    ("krakow", 50.06, 19.94, 780_000),
    ("kyiv", 50.45, 30.52, 2_900_000),
    ("bucharest", 44.43, 26.10, 1_800_000),
    ("sofia", 42.70, 23.32, 1_200_000),
    ("athens", 37.98, 23.73, 660_000),
    ("lisbon", 38.72, -9.14, 550_000),
    ("porto", 41.15, -8.61, 230_000),
    ("barcelona", 41.39, 2.17, 1_600_000),
    ("valencia", 39.47, -0.38, 790_000),
    ("seville", 37.39, -5.99, 690_000),
    ("milan", 45.46, 9.19, 1_400_000),
    ("turin", 45.07, 7.69, 870_000),
    ("naples", 40.85, 14.27, 960_000),
    ("florence", 43.77, 11.26, 380_000),
    ("venice", 45.44, 12.33, 260_000),
    ("munich", 48.14, 11.58, 1_500_000),
    ("frankfurt", 50.11, 8.68, 750_000),
    ("hamburg", 53.55, 9.99, 1_800_000),
    ("cologne", 50.94, 6.96, 1_100_000),
    ("stuttgart", 48.78, 9.18, 630_000),
    ("brussels", 50.85, 4.35, 1_200_000),
    ("antwerp", 51.22, 4.40, 530_000),
    ("rotterdam", 51.92, 4.48, 650_000),
    ("the hague", 52.08, 4.31, 550_000),
    ("geneva", 46.20, 6.14, 200_000),
    ("basel", 47.56, 7.59, 180_000),
    ("lyon", 45.76, 4.84, 520_000),
    ("marseille", 43.30, 5.37, 870_000),
    ("toulouse", 43.60, 1.44, 490_000),
    ("nice", 43.71, 7.26, 340_000),
    ("edinburgh", 55.95, -3.19, 530_000),
    ("glasgow", 55.86, -4.25, 630_000),
    ("manchester", 53.48, -2.24, 550_000),
    ("birmingham", 52.49, -1.89, 1_100_000),
    ("leeds", 53.80, -1.55, 790_000),
    ("bristol", 51.45, -2.59, 470_000),
    ("oxford", 51.75, -1.26, 150_000),
    ("denver", 39.74, -104.99, 710_000),
    ("phoenix", 33.45, -112.07, 1_600_000),
    ("houston", 29.76, -95.37, 2_300_000),
    ("dallas", 32.78, -96.80, 1_300_000),
    ("san antonio", 29.42, -98.49, 1_500_000),
    ("san diego", 32.72, -117.16, 1_400_000),
    ("philadelphia", 39.95, -75.17, 1_600_000),
    ("washington", 38.91, -77.04, 700_000),
    ("atlanta", 33.75, -84.39, 500_000),
    ("miami", 25.76, -80.19, 440_000),
    ("detroit", 42.33, -83.05, 640_000),
    ("minneapolis", 44.98, -93.27, 430_000),
    ("pittsburgh", 40.44, -80.00, 300_000),
    ("baltimore", 39.29, -76.61, 580_000),
    ("nashville", 36.16, -86.78, 690_000),
    ("new orleans", 29.95, -90.07, 380_000),
    ("salt lake city", 40.76, -111.89, 200_000),
    ("las vegas", 36.17, -115.14, 650_000),
    ("raleigh", 35.78, -78.64, 470_000),
    ("palo alto", 37.44, -122.14, 68_000),
    ("mountain view", 37.39, -122.08, 82_000),
    ("cupertino", 37.32, -122.03, 60_000),
    ("redmond", 47.67, -122.12, 73_000),
    ("menlo park", 37.45, -122.18, 33_000),
    ("sunnyvale", 37.37, -122.04, 155_000),
    ("oakland", 37.80, -122.27, 440_000),
    ("berkeley", 37.87, -122.27, 120_000),
    ("san mateo", 37.56, -122.33, 105_000),
    ("santa clara", 37.35, -121.95, 130_000),
    ("bellevue", 47.61, -122.20, 150_000),
    ("boulder", 40.01, -105.27, 105_000),
    # -- homonyms (population-weighted disambiguation) --------------------------
    ("cambridge", 52.21, 0.12, 125_000),           # UK
    ("cambridge", 42.37, -71.11, 118_000),         # MA, USA
    ("portland", 45.52, -122.68, 650_000),         # OR, USA
    ("portland", 43.66, -70.26, 68_000),           # ME, USA
    ("san jose", 37.34, -121.89, 1_000_000),       # CA, USA
    ("san jose", 9.93, -84.08, 340_000),           # Costa Rica
    ("springfield", 39.80, -89.64, 110_000),       # IL, USA
    ("springfield", 42.10, -72.59, 155_000),       # MA, USA
    ("richmond", 37.54, -77.44, 230_000),          # VA, USA
    ("richmond", -37.82, 145.00, 28_000),          # VIC, AU
    ("valencia", 10.16, -68.00, 830_000),          # Venezuela (vs Spain above)
    ("santiago", 19.45, -70.70, 550_000),          # Dominican Rep. (vs Chile)
    # -- countries (anchored at the capital; population = country) ---------------
    ("united states", 38.91, -77.04, 331_000_000),
    ("usa", 38.91, -77.04, 331_000_000),
    ("united kingdom", 51.51, -0.13, 67_000_000),
    ("uk", 51.51, -0.13, 67_000_000),
    ("canada", 45.42, -75.70, 38_000_000),
    ("mexico", 19.43, -99.13, 128_000_000),
    ("brazil", -15.79, -47.88, 212_000_000),
    ("argentina", -34.60, -58.38, 45_000_000),
    ("france", 48.86, 2.35, 67_000_000),
    ("germany", 52.52, 13.41, 83_000_000),
    ("italy", 41.90, 12.50, 60_000_000),
    ("spain", 40.42, -3.70, 47_000_000),
    ("portugal", 38.72, -9.14, 10_000_000),
    ("netherlands", 52.37, 4.90, 17_000_000),
    ("belgium", 50.85, 4.35, 11_500_000),
    ("switzerland", 46.95, 7.45, 8_600_000),
    ("austria", 48.21, 16.37, 9_000_000),
    ("poland", 52.23, 21.01, 38_000_000),
    ("ukraine", 50.45, 30.52, 44_000_000),
    ("russia", 55.76, 37.62, 144_000_000),
    ("sweden", 59.33, 18.07, 10_400_000),
    ("norway", 59.91, 10.75, 5_400_000),
    ("denmark", 55.68, 12.57, 5_800_000),
    ("finland", 60.17, 24.94, 5_500_000),
    ("ireland", 53.35, -6.26, 5_000_000),
    ("greece", 37.98, 23.73, 10_700_000),
    ("turkey", 39.93, 32.86, 84_000_000),
    ("israel", 31.77, 35.21, 9_300_000),
    ("saudi arabia", 24.71, 46.68, 35_000_000),
    ("egypt", 30.04, 31.24, 102_000_000),
    ("nigeria", 9.06, 7.50, 206_000_000),
    ("kenya", -1.29, 36.82, 54_000_000),
    ("south africa", -25.75, 28.19, 59_000_000),
    ("india", 28.70, 77.10, 1_380_000_000),
    ("china", 39.90, 116.41, 1_402_000_000),
    ("japan", 35.68, 139.65, 126_000_000),
    ("south korea", 37.57, 126.98, 52_000_000),
    ("indonesia", -6.21, 106.85, 274_000_000),
    ("thailand", 13.76, 100.50, 70_000_000),
    ("vietnam", 21.03, 105.85, 97_000_000),
    ("philippines", 14.60, 120.98, 110_000_000),
    ("malaysia", 3.14, 101.69, 32_000_000),
    ("pakistan", 33.69, 73.06, 221_000_000),
    ("bangladesh", 23.81, 90.41, 165_000_000),
    ("australia", -35.28, 149.13, 26_000_000),
    ("new zealand", -41.29, 174.78, 5_100_000),
    # -- US states (anchored at the capital; population = state) -----------------
    ("california", 38.58, -121.49, 39_500_000),
    ("texas", 30.27, -97.74, 29_000_000),
    ("florida", 30.44, -84.28, 21_500_000),
    ("new york state", 42.65, -73.76, 20_200_000),
    ("pennsylvania", 40.27, -76.88, 13_000_000),
    ("illinois", 39.80, -89.64, 12_800_000),
    ("ohio", 39.96, -83.00, 11_800_000),
    ("georgia", 33.75, -84.39, 10_700_000),
    ("north carolina", 35.78, -78.64, 10_400_000),
    ("michigan", 42.73, -84.56, 10_000_000),
    ("virginia", 37.54, -77.44, 8_600_000),
    ("colorado", 39.74, -104.99, 5_800_000),
    ("arizona", 33.45, -112.07, 7_300_000),
    ("oregon", 44.94, -123.03, 4_200_000),
    ("utah", 40.76, -111.89, 3_300_000),
    ("nevada", 39.16, -119.77, 3_100_000),
    ("massachusetts", 42.36, -71.06, 6_900_000),
]

# Backwards-compatible view (pre-homonym shape) used by a few tests
_BUILTIN: dict[str, tuple[float, float, int]] = {
    name: (lat, lon, pop) for name, lat, lon, pop in _BUILTIN_ROWS
}


@dataclass
class Toponym:
    name: str  # lowercase matched form (the Experience.toponyms key)
    lat: float
    lon: float
    population: int
    country: str = ""  # ISO 3166-1 alpha-2 (empty for builtin seed rows)
    canonical: str = ""  # GeoNames casing ("Baltimore"); name if unset
    mention: str = ""  # the surface form as it appeared (types.rs:931-935)

    def __post_init__(self) -> None:
        if not self.canonical:
            self.canonical = self.name
        if not self.mention:
            self.mention = self.name


# Shipped artifact (tools/build_gazetteer.py): form \t canonical \t lat \t
# lon \t country \t population, one row per lowercased name form.
_FULL_DATA = Path(__file__).parent / "data" / "geonames_cities.tsv.gz"

# Words the free-text scanner never matches, whatever the casing — question
# openers and function words that double as city names ("Of", "To", "Most").
_NEVER_MATCH = STOPWORDS | {"most", "come", "along", "deal", "best", "date"}

# Tokens: word chars plus inner apostrophes/hyphens ("'s-hertogenbosch").
_TOKEN_RE = re.compile(r"[^\W_]+(?:['’’-][^\W_]+)*", re.UNICODE)
_SENTENCE_BREAK_RE = re.compile(r"[.!?\n\r;:]")

# A single-token non-builtin name matched WITHOUT capitalization evidence
# must resolve to a metropolis: famous cities read unambiguously even in
# lowercase chat ("flying to mumbai"), small homonyms don't ("split the
# bill" — Split, HR, pop 150k).
_LOWERCASE_MIN_POPULATION = 1_000_000


class Gazetteer:
    def __init__(self, tsv_path: Optional[str | Path] = None):
        # name -> list of candidates (homonyms)
        self._places: dict[str, list[Toponym]] = {}
        for name, lat, lon, pop in _BUILTIN_ROWS:
            self._places.setdefault(name, []).append(Toponym(name, lat, lon, pop))
        self._builtin_names = frozenset(self._places)
        # form -> population-argmax place from the shipped GeoNames artifact
        # (mod.rs:120-133 applies the argmax while indexing; so do we).
        self._full: Optional[dict[str, Toponym]] = None
        self._max_ngram = 4
        if tsv_path is not None:
            self.load_tsv(tsv_path)

    # -- data loading ---------------------------------------------------------

    def _full_index(self) -> dict[str, Toponym]:
        """Lazy-load the shipped GeoNames artifact (first call ~100 ms)."""
        if self._full is None:
            index: dict[str, Toponym] = {}
            from shodh_tpu_torch import constants as C

            if C.GAZETTEER_FULL and _FULL_DATA.exists():
                with gzip.open(_FULL_DATA, "rt", encoding="utf-8") as fh:
                    for line in fh:
                        if line.startswith("#"):
                            continue
                        parts = line.rstrip("\n").split("\t")
                        if len(parts) != 6:
                            continue
                        form, canonical, lat, lon, country, pop = parts
                        try:
                            top = Toponym(
                                form, float(lat), float(lon), int(pop), country, canonical
                            )
                        except ValueError:
                            continue
                        prev = index.get(form)
                        if prev is None or top.population > prev.population:
                            index[form] = top
            self._full = index
        return self._full

    def load_tsv(self, path: str | Path) -> int:
        """Load a user-provided GeoNames-style TSV.

        Accepts both the 4-column legacy layout (name, lat, lon, population)
        and the 6-column cities15000 layout (name, asciiname, lat, lon,
        country, population — asciiname empty when identical to name).
        """
        n = 0
        for line in Path(path).read_text(encoding="utf-8", errors="replace").splitlines():
            parts = line.split("\t")
            tops: list[Toponym] = []
            try:
                if len(parts) >= 6:
                    name, asciiname, lat, lon, country, pop = parts[:6]
                    for form in {name.strip().lower(), asciiname.strip().lower()}:
                        if form:
                            tops.append(
                                Toponym(
                                    form,
                                    float(lat),
                                    float(lon),
                                    int(float(pop)),
                                    country,
                                    name.strip(),
                                )
                            )
                elif len(parts) >= 4:
                    tops.append(
                        Toponym(
                            parts[0].lower(), float(parts[1]), float(parts[2]), int(float(parts[3]))
                        )
                    )
            except ValueError:
                continue
            for top in tops:
                self._places.setdefault(top.name, []).append(top)
                n += 1
        return n

    # -- resolution (mod.rs:148-158) ------------------------------------------

    def resolve(self, name: str) -> Optional[Toponym]:
        """Population-weighted homonym resolution: biggest place wins.

        Case-insensitive exact match only — no fuzzy/prefix matching
        (mod.rs:19-23). Considers the builtin seed, ``load_tsv`` rows, and
        the shipped GeoNames artifact together.
        """
        key = name.strip().lower()
        best: Optional[Toponym] = None
        candidates = self._places.get(key)
        if candidates:
            best = max(candidates, key=lambda t: t.population)
        full = self._full_index().get(key)
        if full is not None and (best is None or full.population > best.population):
            best = full
        return best

    def resolve_ner_locations(self, mentions: Iterable[str]) -> list[Toponym]:
        """Resolve NER location mentions into coordinate-bearing toponyms.

        The reference's single remember-path entry point for turning place
        mentions into coordinates (mod.rs:166-206): only location entities
        are offered (the caller filters), unresolved mentions are dropped
        (not an error), repeated mentions collapse to one toponym.
        """
        out: list[Toponym] = []
        seen: set[str] = set()
        for mention in mentions:
            key = mention.strip().lower()
            if not key or key in seen:
                continue
            seen.add(key)
            top = self.resolve(key)
            if top is not None:
                out.append(
                    Toponym(
                        top.name,
                        top.lat,
                        top.lon,
                        top.population,
                        top.country,
                        top.canonical,
                        mention.strip(),
                    )
                )
        return out

    # -- free-text extraction (repo extension; the reference resolves NER
    #    LOC spans only, so it never faces common-word city names) -----------

    def extract_toponyms(self, text: str) -> list[Toponym]:
        """Longest-match n-gram scan for known places in free text.

        O(tokens) dict lookups: at each token position the 4..1-gram joins
        are tried longest-first, and a match advances past its span (so
        "york" never fires inside "new york"). Homonym guard: multi-token
        forms match in any case; single-token forms — builtin seeds
        included ("nice to meet you" matched Nice, FR under the unguarded
        scan) — need either a capitalized surface at a non-sentence-initial
        position or metropolis-scale population. The accepted precision
        tradeoff: an all-lowercase sub-1M single-token city ("going to
        oslo") is dropped unless capitalized mid-sentence.
        """
        tokens = list(_TOKEN_RE.finditer(text))
        if not tokens:
            return []
        lowered = [t.group(0).lower() for t in tokens]
        full = self._full_index()
        out: list[Toponym] = []
        seen: set[str] = set()
        i = 0
        while i < len(tokens):
            matched_len = 0
            for n in range(min(self._max_ngram, len(tokens) - i), 0, -1):
                form = " ".join(lowered[i : i + n])
                top: Optional[Toponym] = None
                if form in self._places:
                    top = self.resolve(form)
                elif form in full:
                    top = full[form]
                if top is not None and n == 1:
                    # The guard applies to builtin names too: "nice to meet
                    # you" matched Nice, FR under the unguarded scan.
                    initial = i == 0 or bool(
                        _SENTENCE_BREAK_RE.search(
                            text[tokens[i - 1].end() : tokens[i].start()]
                        )
                    )
                    if not self._single_token_ok(tokens[i].group(0), initial, top):
                        top = None
                if top is not None:
                    if top.name not in seen:
                        seen.add(top.name)
                        out.append(top)
                    matched_len = n
                    break
            i += matched_len or 1
        return out

    def _single_token_ok(self, surface: str, sentence_initial: bool, top: Toponym) -> bool:
        form = surface.lower()
        if form in _NEVER_MATCH or len(form) < 3:
            return False
        # Capitalization only counts mid-sentence: "Nice to meet you"
        # capitalizes Nice, FR (pop 342k) by position alone.
        if surface[0].isupper() and not sentence_initial:
            return True
        return top.population >= _LOWERCASE_MIN_POPULATION and len(form) >= 4
